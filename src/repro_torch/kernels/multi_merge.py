"""``multi_merge_ranks``: ranks of k sorted int64 rows in their stable
k-way merge.

The rows come concatenated with CSR row offsets (``offs[i]`` is the
start of row ``i``, ``offs[k]`` the total), not padded to a common
length.  The CUDA kernel (``csrc/multi_merge.cu``) replaces the Pallas
multi-merge kernel of the reference.  ``multi_merge_ranks`` launches it
for tensors on a CUDA device and takes the plain version,
``multi_merge_ranks_plain``, only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

#: repro_multi_merge_ranks(keys, offs, k, total, ranks, stream)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p)


@functools.cache
def _kernel() -> ctypes._CFuncPtr:
    """The typed C entry point, resolved (and built) once a process."""
    return build.function("multi_merge", "repro_multi_merge_ranks",
                          _ARGTYPES)


def _check(keys: torch.Tensor, offs: torch.Tensor) -> None:
    for name, t in (("keys", keys), ("offs", offs)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"multi_merge_ranks: {name} must be a "
                             f"contiguous 1-D int64 tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if keys.device != offs.device:
        raise ValueError(f"multi_merge_ranks: keys on {keys.device}, offs "
                         f"on {offs.device}")
    if offs.shape[0] < 2:
        raise ValueError("multi_merge_ranks: offs needs k + 1 >= 2 entries")


def multi_merge_ranks_plain(keys: torch.Tensor, offs: torch.Tensor
                            ) -> torch.Tensor:
    """Rank of every element in the stable merge of the rows (ties by
    row, then by position): the inverse of a stable sort's order.  On
    sorted rows that is own index + sum_{j<i} #(row_j <= e) +
    sum_{j>i} #(row_j < e)."""
    order = torch.sort(keys, stable=True).indices
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(len(keys), dtype=torch.int64,
                                device=keys.device)
    return ranks


def multi_merge_ranks(keys: torch.Tensor, offs: torch.Tensor
                      ) -> torch.Tensor:
    """``multi_merge_ranks_plain``'s function; on a CUDA device, one
    launch of the hand-written kernel (counted on
    ``multi_merge_ranks.launches``) on the device's current stream.
    ``offs`` must end at ``len(keys)`` and each row must be sorted."""
    _check(keys, offs)
    # host time counts here as in merge.merge_path
    if not keys.is_cuda:
        if keys.is_cpu:
            return multi_merge_ranks_plain(keys, offs)
        raise ValueError(f"multi_merge_ranks: no kernel for device "
                         f"{keys.device}")
    ranks = torch.empty_like(keys)
    total = keys.shape[0]
    if total == 0:
        return ranks
    fn = _kernel()
    multi_merge_ranks.launches += 1
    build.check("multi_merge", fn(
        keys.data_ptr(), offs.data_ptr(), offs.shape[0] - 1, total,
        ranks.data_ptr(),
        torch.cuda.current_stream(keys.get_device()).cuda_stream))
    return ranks


multi_merge_ranks.launches = 0
