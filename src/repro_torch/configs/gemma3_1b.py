"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144, 5:1 local:global sliding-window attention, 128k context.
[hf:google/gemma-3-1b-pt]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    arch_type="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    layer_pattern="LLLLLG",        # 5 local : 1 global
    sliding_window=512,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
).validate()
