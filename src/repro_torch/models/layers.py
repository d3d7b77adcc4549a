"""Composable transformer building blocks (PyTorch port of the
reference's ``models/layers.py``): norms, rotary embeddings, attention
(GQA, optional qk-norm / qkv-bias), the FFN, embeddings, the LM head and
the loss.

Parameters live in ``Params`` modules under the reference's names, and
``p["name"]`` reads them as the reference reads its pytree, so the
functions below keep the reference's signatures.  The reference's
``sharding.logical.constrain`` calls are dropped: they are no-ops
without a device mesh, and the port runs on one device.

``mha`` runs on the hand-written ``flash_attention`` kernel (its plain
version for tensors on the CPU) where the reference computes attention
in plain jnp, blocked by ``cfg.attn_chunk``: the kernel streams the keys
itself, so the port has no chunk loop and no KV repeat.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention

#: ModelConfig.dtype -> torch dtype
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class Params(nn.Module):
    """An ``nn.Module`` whose parameters and submodules read by name,
    ``p["w_in"]``, like the reference's parameter dictionaries.  The
    port runs inference only, so parameters take no gradient."""

    def add(self, name: str, value: torch.Tensor) -> None:
        self.register_parameter(name, nn.Parameter(value,
                                                   requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _normal(shape, gen: Optional[torch.Generator], device, scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    """Seeded N(0, scale^2) weights from ``gen``; without a generator,
    uninitialised storage for weights that are loaded next (``carry``)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, device=device)
            * scale).to(dtype)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as JAX promotes a
    bf16 activation meeting an fp32 weight (whisper's bf16 frames in an
    fp32 model); torch refuses mixed-dtype products."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# ---------------------------------------------------------------------- #
# norms
# ---------------------------------------------------------------------- #
def init_rmsnorm(cfg: ModelConfig, dim: Optional[int] = None,
                 device=None) -> Params:
    p = Params()
    if not cfg.nonparam_ln:
        p.add("scale", torch.ones(dim or cfg.d_model, dtype=torch.float32,
                                  device=device))
    return p


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if "scale" in p:
        y = y * p["scale"]
    return y.to(dt)


def layernorm_np(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Non-parametric LayerNorm (olmo): normalize, no scale/bias."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dt)


def norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.nonparam_ln:
        return layernorm_np(x, cfg.norm_eps)
    return rmsnorm(p, x, cfg.norm_eps)


# ---------------------------------------------------------------------- #
# rotary position embeddings
# ---------------------------------------------------------------------- #
def rope_freqs(cfg: ModelConfig, device=None) -> torch.Tensor:
    h = cfg.hdim
    return 1.0 / (cfg.rope_theta ** (torch.arange(
        0, h, 2, dtype=torch.float32, device=device) / h))


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; pos: [..., seq].  Half-split
    (not interleaved) rotation; angles in fp32, each half cast to
    ``x``'s dtype before the concat, as in the reference."""
    angles = pos[..., :, None, None].float() * freqs        # [...,s,1,h/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    dt = x.dtype
    return torch.cat([(x1 * cos - x2 * sin).to(dt),
                      (x1 * sin + x2 * cos).to(dt)], dim=-1)


# ---------------------------------------------------------------------- #
# attention (GQA, optional qk-norm / qkv-bias)
# ---------------------------------------------------------------------- #
def init_attention(cfg: ModelConfig, gen: Optional[torch.Generator],
                   device=None) -> Params:
    d, h, nh, nkv = cfg.d_model, cfg.hdim, cfg.n_heads, cfg.n_kv_heads
    s = 1.0 / math.sqrt(d)
    dt = _dtype(cfg)
    p = Params()
    p.add("wq", _normal((d, nh * h), gen, device, s, dt))
    p.add("wk", _normal((d, nkv * h), gen, device, s, dt))
    p.add("wv", _normal((d, nkv * h), gen, device, s, dt))
    p.add("wo", _normal((nh * h, d), gen, device, s, dt))
    if cfg.qkv_bias:
        for name, n in (("bq", nh * h), ("bk", nkv * h), ("bv", nkv * h)):
            p.add(name, torch.zeros(n, dtype=dt, device=device))
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p.add(name, torch.ones(h, dtype=torch.float32, device=device))
    return p


def _qkv(cfg: ModelConfig, p, x: torch.Tensor, pos: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    nh, nkv, h = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    q = _mm(x, p["wq"])
    k = _mm(x, p["wk"])
    v = _mm(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, nh, h)
    k = k.reshape(b, s, nkv, h)
    v = v.reshape(b, s, nkv, h)
    if cfg.qk_norm:
        q = rmsnorm({"scale": p["q_norm"]}, q, cfg.norm_eps)
        k = rmsnorm({"scale": p["k_norm"]}, k, cfg.norm_eps)
    freqs = rope_freqs(cfg, x.device)
    return apply_rope(q, pos, freqs), apply_rope(k, pos, freqs), v


def mha(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        causal: bool = True) -> torch.Tensor:
    """Attention over [b, sq, nh, h] x [b, sk, nkv, h] -> [b, sq, nh, h]:
    one ``flash_attention`` call on [b, h, s, d] views (the kernel folds
    each query head onto its KV group and writes its output in ``q``'s
    layout).  The mask is top-left aligned, as the reference's without
    ``q_offset``, which no caller passes.

    In bf16 the reference rounds the softmax weights to ``v``'s dtype
    before the PV product, and so does the kernel (P = exp(s - m) in
    bf16 on the tensor cores, the division by the fp32 sum at the end);
    the plain version, which the CPU takes, keeps them in fp32.  In fp32
    all agree to reassociation."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)


def attention(cfg: ModelConfig, p, x: torch.Tensor, pos: torch.Tensor,
              causal: bool = True,
              kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> torch.Tensor:
    """Full attention block (no cache).  ``kv`` overrides keys/values for
    cross-attention (whisper decoder): the mask is then non-causal and
    only ``q`` takes RoPE at ``pos``.

    The kernel takes q, k and v of one dtype, so ``q`` and ``kv`` are
    cast to their promoted dtype first.  For a bf16 cross cache in an
    fp32 model the reference promotes in the QK product and then rounds
    the softmax weights to bf16 for PV; here PV stays fp32, so the two
    agree to bf16 rounding there, not to fp32 reassociation."""
    b, s, d = x.shape
    q, k, v = _qkv(cfg, p, x, pos)
    if kv is not None:
        k, v = kv
        causal = False
        dt = torch.promote_types(q.dtype, k.dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
    out = mha(cfg, q, k, v, causal=causal)
    out = out.reshape(b, s, cfg.n_heads * cfg.hdim)
    return _mm(out, p["wo"]).to(x.dtype)


def attention_decode(cfg: ModelConfig, p, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode with a KV cache, in plain torch (the reference
    computes it outside any kernel).

    x: [b, 1, d]; cache_[kv]: [b, S, nkv, h]; pos: [b] absolute position.
    The reference writes the new key and value with a one-hot blend;
    here they are copied in place into slot ``pos`` of each row, which
    gives the same values without rewriting the cache.  A cache of a
    narrower dtype than the model's is widened first, as the blend
    promotes it in the reference."""
    b, _, d = x.shape
    q, k_new, v_new = _qkv(cfg, p, x, pos[:, None])
    wide = torch.promote_types(cache_k.dtype, k_new.dtype)
    if cache_k.dtype != wide:
        cache_k, cache_v = cache_k.to(wide), cache_v.to(wide)
    S = cache_k.shape[1]
    slot = torch.arange(b, device=x.device) * S + pos
    cache_k.view(b * S, *cache_k.shape[2:]).index_copy_(
        0, slot, k_new[:, 0].to(wide))
    cache_v.view(b * S, *cache_v.shape[2:]).index_copy_(
        0, slot, v_new[:, 0].to(wide))
    # mask out cache slots beyond pos
    nh, nkv, h = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    group = nh // nkv
    qr = q.reshape(b, nkv, group, h)
    logits = torch.einsum("bkgh,bskh->bkgs", qr.float(),
                          cache_k.float()) / math.sqrt(h)
    valid = torch.arange(S, device=x.device)[None] <= pos[:, None]
    logits = torch.where(valid[:, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", w, cache_v).reshape(b, 1, nh * h)
    return _mm(out, p["wo"]), cache_k, cache_v


# ---------------------------------------------------------------------- #
# FFN
# ---------------------------------------------------------------------- #
def init_ffn(cfg: ModelConfig, gen: Optional[torch.Generator],
             device=None, d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = _dtype(cfg)
    p = Params()
    p.add("w_in", _normal((d, f), gen, device, 1.0 / math.sqrt(d), dt))
    p.add("w_out", _normal((f, d), gen, device, 1.0 / math.sqrt(f), dt))
    if cfg.act in ("swiglu", "geglu"):
        p.add("w_gate", _normal((d, f), gen, device, 1.0 / math.sqrt(d), dt))
    return p


def ffn(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """swiglu, geglu (grok-1-style gated gelu) or gelu; gelu is the tanh
    approximation, ``jax.nn.gelu``'s default."""
    h = _mm(x, p["w_in"])
    if cfg.act == "swiglu":
        h = F.silu(_mm(x, p["w_gate"])) * h
    elif cfg.act == "geglu":
        h = F.gelu(_mm(x, p["w_gate"]), approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return _mm(h, p["w_out"]).to(x.dtype)


# ---------------------------------------------------------------------- #
# embeddings / head
# ---------------------------------------------------------------------- #
def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rounded up to a multiple of 256, as in the reference; pad
    logits are masked to -1e30 in ``lm_head``."""
    return -(-cfg.vocab // 256) * 256


def init_embedding(cfg: ModelConfig, gen: Optional[torch.Generator],
                   device=None) -> Params:
    dt = _dtype(cfg)
    pv = padded_vocab(cfg)
    p = Params()
    p.add("tok", _normal((pv, cfg.d_model), gen, device, 0.02, dt))
    if not cfg.tie_embeddings:
        p.add("head", _normal((cfg.d_model, pv), gen, device, 0.02, dt))
    return p


def embed(cfg: ModelConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def lm_head(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Logits over the PADDED vocab (pad positions masked to -1e30 so
    softmax/xent/argmax are exact); callers may slice [..., :vocab]."""
    w = p["head"] if "head" in p else p["tok"].T
    logits = x @ w
    pv = logits.shape[-1]
    if pv != cfg.vocab:
        pad = torch.arange(pv, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)
