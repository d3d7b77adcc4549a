"""Plain oracles of the model-zoo kernels (the reference's
``kernels/ref.py``): the allclose authority the kernels and their plain
versions are held to.  ``ssd_chunk``'s oracle is its plain version,
``ssd_chunk.ssd_chunk_plain``; the seam kernels are held to numpy.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: [b, h, sq, d]; k, v: [b, hkv, sk, d] (GQA broadcast).  Scores,
    softmax and the PV product in float32; the causal mask is top-left
    aligned (query i sees keys j <= i); the result in ``q``'s dtype."""
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = h // hkv
    qr = q.reshape(b, hkv, group, sq, d).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qr, k.float()) / math.sqrt(d)
    if causal:
        mask = torch.arange(sq, device=q.device)[:, None] >= \
            torch.arange(sk, device=q.device)[None, :]
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)


def block_sparse_matmul_ref(a_masked: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """Oracle over the tile-masked dense A (float32 accumulate)."""
    return a_masked.float() @ b.float()


def tile_mask(a: np.ndarray, bm: int, bk: int) -> np.ndarray:
    """Zero out (bm x bk) tiles of ``a`` that are entirely zero (no-op
    numerically -- returns ``a`` with the same nonzero tiles)."""
    m, k = a.shape
    out = np.zeros_like(a)
    for i in range(0, m, bm):
        for j in range(0, k, bk):
            t = a[i:i + bm, j:j + bk]
            if np.any(t != 0):
                out[i:i + bm, j:j + bk] = t
    return out
