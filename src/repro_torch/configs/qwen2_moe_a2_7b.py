"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (MHA kv=16) d_ff=1408
vocab=151936, MoE 60 routed top-4 + 4 shared
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                  # routed-expert FFN width
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, d_expert=1408),
)

SMOKE = CONFIG.smoke()
