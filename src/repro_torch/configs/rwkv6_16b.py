"""rwkv6-1.6b [ssm] "Finch": 24L d_model=2048 (attention-free)
d_ff=7168 vocab=65536, data-dependent decay.  [arXiv:2404.05892]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,                  # 2048 / 64-dim wkv heads
    d_ff=7168,
    vocab_size=65536,
    layer_pattern="W",
    norm="layernorm",
    source="arXiv:2404.05892",
).validate()
