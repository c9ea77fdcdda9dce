"""whisper-tiny [audio]: enc-dec, conv frontend stubbed to frame
embeddings.  4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.
[arXiv:2212.04356]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    arch_type="audio",
    num_layers=4,                 # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    qkv_bias=True,
    mlp_gated=False,              # GELU MLP
    norm="layernorm",
    layer_pattern="C",            # every decoder layer cross-attends
    encoder_layers=4,
    encoder_seq=1500,             # 30 s of audio at 50 frames/s
    source="arXiv:2212.04356",
).validate()
