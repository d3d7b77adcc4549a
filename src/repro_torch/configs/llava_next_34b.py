"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 - anyres tiling; patch embeddings are a precomputed STUB
prepended to the token stream  [hf:llava-hf/...; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    head_dim=128,
    rope_theta=5e6,
    # anyres: base 576 + 4 tiles x 576 patches = 2880 patch embeddings
    n_patches=2880,
)

SMOKE = CONFIG.smoke()
