"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) expert d_ff=32768
vocab=131072, 8 experts top-2.  [hf:xai-org/grok-1]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    layer_pattern="G",
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=32768,
    source="hf:xai-org/grok-1",
).validate()
