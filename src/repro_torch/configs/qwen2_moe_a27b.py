"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=151936, 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    layer_pattern="G",
    num_experts=60,
    experts_per_token=4,
    moe_d_ff=1408,
    shared_expert_d_ff=4 * 1408,    # 4 shared experts, fused
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
).validate()
