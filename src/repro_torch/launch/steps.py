"""Prefill and serve step builders (the reference's ``launch/steps.py``).

A step runs on the CUDA device unless ``make_*_step`` is given another
``device``; without a card and without ``device="cpu"`` it raises.
Steps run under ``torch.inference_mode``: the port has no backward yet,
so ``make_train_step`` and the input-spec functions come with the
training slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backends import resolve_device
from repro_torch.models import api


def make_prefill_step(cfg: ModelConfig, device=None) -> Callable:
    """Forward logits over the full prompt (inference prefill)."""
    device = resolve_device(device)
    mod = api._mod(cfg)

    def prefill_step(params: nn.Module, batch: Dict[str, torch.Tensor]):
        with torch.inference_mode():
            tokens = batch["tokens"].to(device)
            if cfg.family == "encdec":
                return mod.forward(cfg, params, tokens,
                                   batch["frames"].to(device))
            if cfg.family == "vlm":
                return mod.forward(cfg, params, tokens,
                                   extra_embeds=batch["patches"].to(device))
            if cfg.family in ("moe", "hybrid"):
                logits, _aux = mod.forward(cfg, params, tokens)
                return logits
            return mod.forward(cfg, params, tokens)

    return prefill_step


def make_serve_step(cfg: ModelConfig, device=None) -> Callable:
    """One decode step for every slot of the batch."""
    device = resolve_device(device)

    def serve_step(params: nn.Module, cache: Dict[str, torch.Tensor],
                   token: torch.Tensor, pos: torch.Tensor):
        with torch.inference_mode():
            return api.serve_step(cfg, params, cache, token.to(device),
                                  pos.to(device))

    return serve_step
