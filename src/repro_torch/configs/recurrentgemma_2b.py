"""recurrentgemma-2b [hybrid] Griffin: 26L d_model=2560 10H (kv=1)
d_ff=7680, RG-LRU + local attention in a 2:1 pattern.
[arXiv:2402.19427]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern="RRL",            # 2 recurrent : 1 local-attention
    sliding_window=2048,
    rnn_width=2560,
    conv1d_width=4,
    tie_embeddings=True,
    source="arXiv:2402.19427",
).validate()
