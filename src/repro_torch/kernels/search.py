"""``search``: int64 lower-bound search of probes in a sorted haystack.

The CUDA kernel (``csrc/search.cu``) replaces the Pallas intersection
kernel of the reference.  ``search`` launches it for tensors on a CUDA
device and takes the plain version, ``search_plain``, only for tensors
on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

#: repro_search(hay, m, probes, n, out, stream)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p)


def _check(hay: torch.Tensor, probes: torch.Tensor) -> None:
    for name, t in (("hay", hay), ("probes", probes)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"search: {name} must be a contiguous 1-D "
                             f"int64 tensor, got {t.dtype} {tuple(t.shape)}")
    if hay.device != probes.device:
        raise ValueError(f"search: hay on {hay.device}, probes on "
                         f"{probes.device}")


def search_plain(hay: torch.Tensor, probes: torch.Tensor) -> torch.Tensor:
    """Position in ``hay`` (sorted, unique) of every probe (any order,
    duplicates fine), -1 where absent: ``torch.searchsorted`` plus the
    hit test."""
    if len(hay) == 0:
        return torch.full_like(probes, -1)
    pos = torch.searchsorted(hay, probes)
    safe = pos.clamp(max=len(hay) - 1)
    hit = (pos < len(hay)) & (hay[safe] == probes)
    return torch.where(hit, safe, torch.full_like(safe, -1))


def search(hay: torch.Tensor, probes: torch.Tensor) -> torch.Tensor:
    """``search_plain``'s function; on a CUDA device, one launch of the
    hand-written kernel (counted on ``search.launches``)."""
    _check(hay, probes)
    if probes.device.type == "cpu":
        return search_plain(hay, probes)
    if probes.device.type != "cuda":
        raise ValueError(f"search: no kernel for device {probes.device}")
    out = torch.empty_like(probes)
    if len(probes) == 0:
        return out
    fn = build.function("search", "repro_search", _ARGTYPES)
    stream = torch.cuda.current_stream(probes.device).cuda_stream
    search.launches += 1
    build.check("search", fn(hay.data_ptr(), len(hay), probes.data_ptr(),
                             len(probes), out.data_ptr(), stream))
    return out


search.launches = 0
