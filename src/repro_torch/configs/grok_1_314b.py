"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2  [hf:xai-org/grok-1; unverified]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    head_dim=128,
    act="geglu",                # grok-1 gated-gelu MLP (3 matrices)
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=0, d_expert=32768),
)

SMOKE = CONFIG.smoke()
