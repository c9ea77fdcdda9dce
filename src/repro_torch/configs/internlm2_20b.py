"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544.  [arXiv:2403.17297]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    arch_type="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    layer_pattern="G",
    source="arXiv:2403.17297",
).validate()
