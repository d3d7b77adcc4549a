"""Model / shape configuration dataclasses shared across the framework."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0                 # shared (always-on) experts
    d_expert: Optional[int] = None    # expert FFN width (default: d_ff)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    # n_heads derived: d_inner / head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None    # default: d_model // n_heads
    # architectural options
    qk_norm: bool = False             # qwen3
    qkv_bias: bool = False            # qwen2
    nonparam_ln: bool = False         # olmo: non-parametric LayerNorm
    tie_embeddings: bool = False
    act: str = "swiglu"               # swiglu | gelu
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    # family extensions
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (jamba): layers per block and which position is attention
    hybrid_block: int = 8             # 1 attention : 7 mamba
    hybrid_attn_idx: int = 4
    moe_every: int = 1                # jamba: MoE on every 2nd layer
    # enc-dec (whisper): encoder layers (decoder = n_layers)
    enc_layers: int = 0
    enc_frames: int = 1500            # precomputed frame embeddings (stub)
    # vlm (llava): patch embeddings prepended (stub)
    n_patches: int = 0
    # Megatron-style sequence parallelism: residual stream sharded over
    # 'model' between blocks (AG before attention/FFN, RS after)
    seq_parallel: bool = False
    # query-block size for chunked reference attention (None = one block)
    attn_chunk: Optional[int] = 1024
    # The reference's scan_layers, remat and use_kernels switches have no
    # counterpart: the port runs its layers in a Python loop, has no
    # backward yet, and ``ssd`` always launches its kernel on the card.
    dtype: str = "bfloat16"

    @property
    def hdim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run 500k-token decode? (SSM / hybrid only)"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True                   # all assigned archs generate tokens

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if self.family != "hybrid"
                         else self.hybrid_block),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads
            < self.n_heads else 4,
            d_ff=256,
            vocab=512,
            head_dim=32,
            enc_layers=2 if self.enc_layers else 0,
            enc_frames=16 if self.enc_layers else self.enc_frames,
            n_patches=8 if self.n_patches else 0,
        )
        if self.moe:
            kw["moe"] = replace(self.moe, n_experts=min(self.moe.n_experts, 4),
                                top_k=min(self.moe.top_k, 2),
                                n_shared=min(self.moe.n_shared, 1),
                                d_expert=64)
        if self.ssm:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=16, chunk=16)
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cells(cfg: ModelConfig) -> List[str]:
    """The shape cells this architecture runs (long_500k only for
    sub-quadratic families, per the brief)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out


def param_count(cfg: ModelConfig) -> float:
    """Approximate parameter count (for MODEL_FLOPS = 6*N*D)."""
    d, h = cfg.d_model, cfg.hdim
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    att = d * (cfg.n_heads * h) + 2 * d * (cfg.n_kv_heads * h) \
        + (cfg.n_heads * h) * d
    ffn_mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    per_layer: float = 0.0
    if cfg.family == "ssm":
        s = cfg.ssm
        d_in = s.expand * d
        per_layer = d * (2 * d_in + 2 * s.d_state + d_in // s.head_dim) \
            + d_in * d + d_in * s.d_conv
        return cfg.n_layers * per_layer + emb
    if cfg.family == "hybrid":
        s = cfg.ssm
        d_in = s.expand * d
        mamba = d * (2 * d_in + 2 * s.d_state + d_in // s.head_dim) \
            + d_in * d
        n_attn = cfg.n_layers // cfg.hybrid_block
        n_mamba = cfg.n_layers - n_attn
        moe_layers = cfg.n_layers // cfg.moe_every
        dense_layers = cfg.n_layers - moe_layers
        ffn = ffn_mult * d * cfg.d_ff
        moe_ffn = cfg.moe.n_experts * ffn_mult * d * \
            (cfg.moe.d_expert or cfg.d_ff)
        return (n_attn * att + n_mamba * mamba + dense_layers * ffn
                + moe_layers * moe_ffn + emb)
    if cfg.family == "moe":
        ffn = cfg.moe.n_experts * ffn_mult * d * (cfg.moe.d_expert or cfg.d_ff)
        ffn += cfg.moe.n_shared * ffn_mult * d * (cfg.moe.d_expert
                                                  or cfg.d_ff)
        ffn += d * cfg.moe.n_experts            # router
    else:
        ffn = ffn_mult * d * cfg.d_ff
    layers = cfg.n_layers + cfg.enc_layers
    return layers * (att + ffn) + emb


def active_param_count(cfg: ModelConfig) -> float:
    """Active params per token (MoE: only routed top-k experts count)."""
    if cfg.family not in ("moe", "hybrid") or cfg.moe is None:
        return param_count(cfg)
    d = cfg.d_model
    ffn_mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    de = cfg.moe.d_expert or cfg.d_ff
    full = cfg.moe.n_experts * ffn_mult * d * de
    active = (cfg.moe.top_k + cfg.moe.n_shared) * ffn_mult * d * de
    if cfg.family == "hybrid":
        moe_layers = cfg.n_layers // cfg.moe_every
        return param_count(cfg) - moe_layers * (full - active
                                                - cfg.moe.n_shared
                                                * ffn_mult * d * de)
    return param_count(cfg) - cfg.n_layers * (full + cfg.moe.n_shared
                                              * ffn_mult * d * de
                                              - active)
