"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16 experts top-2, Mamba+attn 1:7
interleave  [arXiv:2403.19887; hf]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    head_dim=128,
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_expert=24576),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    hybrid_block=8,            # 1 attention : 7 mamba
    hybrid_attn_idx=4,
    moe_every=2,               # MoE on every other layer
)

SMOKE = CONFIG.smoke()
