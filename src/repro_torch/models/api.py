"""Family-dispatching model API (the reference's ``models/api.py``).

    init(cfg, gen, device)                      -> params (an nn.Module)
    loss_fn(cfg, params, batch)                 -> scalar loss (forward only)
    init_cache(cfg, batch, max_len, dtype, device) -> decode cache
    serve_step(cfg, params, cache, token, pos)  -> (logits, cache)

Batch layout per family:
    dense/moe/ssm/hybrid: {tokens [b, s] int64, labels [b, s] int64}
    vlm:                  + patches [b, n_patches, d_model] bf16
    encdec:               + frames  [b, enc_frames, d_model] bf16

The moe and hybrid forwards return ``(logits, aux)``; ``loss_fn`` adds
the router's auxiliary loss.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, moe, ssm, transformer

_FAMILIES = {"dense": transformer, "vlm": transformer, "moe": moe,
             "ssm": ssm, "hybrid": hybrid, "encdec": encdec}


def _mod(cfg: ModelConfig):
    return _FAMILIES[cfg.family]


def init(cfg: ModelConfig, gen: torch.Generator, device=None) -> nn.Module:
    return _mod(cfg).init(cfg, gen, device)


def loss_fn(cfg: ModelConfig, params: nn.Module,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return _mod(cfg).loss_fn(cfg, params, batch)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    return _mod(cfg).init_cache(cfg, batch, max_len, dtype, device)


def serve_step(cfg: ModelConfig, params: nn.Module,
               cache: Dict[str, torch.Tensor], token: torch.Tensor,
               pos: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return _mod(cfg).serve_step(cfg, params, cache, token, pos)


def make_batch(cfg: ModelConfig, gen: torch.Generator, batch: int,
               seq: int) -> Dict[str, torch.Tensor]:
    """Random batch with the family's layout, on ``gen``'s device."""
    kw = dict(generator=gen, device=gen.device)
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, seq), **kw),
           "labels": torch.randint(0, cfg.vocab, (batch, seq), **kw)}
    if cfg.family == "vlm":
        # labels cover only the token positions
        out["patches"] = torch.randn((batch, cfg.n_patches, cfg.d_model),
                                     **kw).to(torch.bfloat16)
    if cfg.family == "encdec":
        out["frames"] = torch.randn((batch, cfg.enc_frames, cfg.d_model),
                                    **kw).to(torch.bfloat16)
    return out


def param_bytes(params: nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())
