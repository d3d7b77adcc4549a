"""whisper-small [audio]: 12L d_model=768 12H (MHA kv=12) d_ff=3072
vocab=51865 - enc-dec, conv frontend STUB (precomputed frame
embeddings via ``input_specs``)  [arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,               # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    head_dim=64,
    act="gelu",
    enc_layers=12,
    enc_frames=1500,           # 30 s of audio after the conv stub
)

SMOKE = CONFIG.smoke()
