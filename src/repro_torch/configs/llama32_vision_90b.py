"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256; cross-attention image layers every 5th layer.
The ViT vision encoder + projector are stubbed: the images come in as
projected patch embeddings (B, num_image_tokens, d_model).
[hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    layer_pattern="GGGGC",          # every 5th layer cross-attends (20 of 100)
    num_image_tokens=1601,          # 1 tile of 560x560 at patch 14 + cls
    source="hf:meta-llama/Llama-3.2-11B-Vision",
).validate()
