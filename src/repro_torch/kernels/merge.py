"""``merge_path``: stable 2-way merge of sorted int64 keys.

The CUDA kernel (``csrc/merge_path.cu``) replaces the Pallas merge-path
kernel of the reference.  ``merge_path`` launches it for tensors on a
CUDA device and takes the plain version, ``merge_path_plain``, only for
tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

#: repro_merge_path(a, n, b, m, merged, src, stream)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p)


@functools.cache
def _kernel() -> ctypes._CFuncPtr:
    """The typed C entry point, resolved (and built) once a process."""
    return build.function("merge_path", "repro_merge_path", _ARGTYPES)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"merge_path: {name} must be a contiguous 1-D "
                             f"int64 tensor, got {t.dtype} {tuple(t.shape)}")
    if a.device != b.device:
        raise ValueError(f"merge_path: a on {a.device}, b on {b.device}")


def merge_path_plain(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable merge of sorted ``a`` and ``b``: (merged keys, int8 source
    flag: 0 from ``a``, 1 from ``b``; ``a`` first on equal keys), by a
    stable sort of the concatenation."""
    merged, order = torch.sort(torch.cat([a, b]), stable=True)
    return merged, (order >= len(a)).to(torch.int8)


def merge_path(a: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``merge_path_plain``'s function; on a CUDA device, one launch of
    the hand-written kernel (counted on ``merge_path.launches``) on the
    device's current stream."""
    _check(a, b)
    # host time is most of a launch at the simulator's sizes: is_cuda,
    # shape[0] and an int device index cost less of it than device.type,
    # len() and a torch.device
    if not a.is_cuda:
        if a.is_cpu:
            return merge_path_plain(a, b)
        raise ValueError(f"merge_path: no kernel for device {a.device}")
    n, m = a.shape[0], b.shape[0]
    merged = torch.empty(n + m, dtype=torch.int64, device=a.device)
    src = torch.empty(n + m, dtype=torch.int8, device=a.device)
    if n + m == 0:
        return merged, src
    fn = _kernel()
    merge_path.launches += 1
    build.check("merge_path", fn(
        a.data_ptr(), n, b.data_ptr(), m, merged.data_ptr(), src.data_ptr(),
        torch.cuda.current_stream(a.get_device()).cuda_stream))
    return merged, src


merge_path.launches = 0
