"""Gradient compression for a cross-host gradient all-reduce (the
reference's ``runtime/compression.py`` on tensors).

Two composable schemes:

  * top-k sparsification with ERROR FEEDBACK: transmit the largest-|g|
    k fraction; the residual is carried into the next step's gradient
    (EF-SGD), which keeps convergence guarantees;
  * int8 quantization with per-tensor scale (symmetric), for a further
    4x over bf16 on the wire.

Trees are name -> tensor dicts, as the optimizers take them.
``torch.topk`` may order equal magnitudes otherwise than
``jax.lax.top_k`` (which keeps the lower index first); the kept set and
the residual differ only where magnitudes tie at the k-th place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------- #
# top-k with error feedback
# ---------------------------------------------------------------------- #
def topk_compress(g: torch.Tensor, frac: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the top-``frac`` fraction by |value|.

    Returns (values [k], indices [k], residual g - kept)."""
    flat = g.reshape(-1).float()
    k = max(1, int(flat.shape[0] * frac))
    _, idx = torch.topk(flat.abs(), k)
    kept = flat[idx]
    residual = flat.clone()
    residual[idx] = 0.0
    return kept, idx, residual.reshape(g.shape).to(g.dtype)


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    out = torch.zeros(math.prod(shape), dtype=torch.float32,
                      device=vals.device)
    out[idx] = vals.float()
    return out.reshape(shape).to(dtype)


@dataclass
class ErrorFeedback:
    """Carries the compression residual across steps (EF-SGD)."""
    frac: float = 0.01

    def init(self, grads: Params) -> Params:
        return {k: torch.zeros_like(g) for k, g in grads.items()}

    def compress(self, grads: Params, residuals: Params
                 ) -> Tuple[Dict[str, Dict[str, torch.Tensor]], Params]:
        """-> (compressed {vals, idx} per name, new residuals)."""
        comp, new_res = {}, {}
        for k, g in grads.items():
            vals, idx, res = topk_compress(
                g + residuals[k].to(g.dtype), self.frac)
            comp[k] = {"vals": vals, "idx": idx}
            new_res[k] = res
        return comp, new_res

    def decompress(self, comp: Dict[str, Dict[str, torch.Tensor]],
                   like: Params) -> Params:
        return {k: topk_decompress(comp[k]["vals"], comp[k]["idx"],
                                   tuple(g.shape), g.dtype)
                for k, g in like.items()}


# ---------------------------------------------------------------------- #
# int8 symmetric quantization
# ---------------------------------------------------------------------- #
def int8_quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g.float())) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)
