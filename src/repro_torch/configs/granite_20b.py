"""granite-20b [dense, code]: 52L d_model=6144 48H (GQA kv=1 = MQA)
d_ff=24576 vocab=49152  [arXiv:2405.04324; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,              # MQA
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    act="gelu",                # granite code models use gelu MLPs
)

SMOKE = CONFIG.smoke()
