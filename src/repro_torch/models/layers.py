"""Building blocks of the SSM family (PyTorch port of the reference's
``models/layers.py``: norms, embeddings, the LM head and the loss).

Parameters live in ``Params`` modules under the reference's names, and
``p["name"]`` reads them as the reference reads its pytree, so the
functions below keep the reference's signatures.  The reference's
``sharding.logical.constrain`` calls are dropped: they are no-ops
without a device mesh, and the port runs on one device.  Rope,
attention and the FFN come with the dense families (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig

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
