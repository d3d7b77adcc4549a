"""``block_sparse_matmul``: SIGMA's tile-sparse matmul,

    Z[m, N] = sum_t A_tile[t] @ B[cols[t]]  scattered to tile-row rows[t],

over the compacted nonzero (bm x bk) tiles of A (``compact_tiles``, host
numpy: SIGMA's filter cascade at tile granularity).

The CUDA kernel (``csrc/block_sparse_matmul.cu``) replaces the
reference's Pallas kernel ``_bsmm_kernel``.  ``block_sparse_matmul``
launches it for tensors on a CUDA device and takes the plain version,
``block_sparse_matmul_plain``, only for tensors on the CPU.  Both
accumulate in float32 and return float32.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build

#: repro_block_sparse_matmul(a, rowptr, cols, b, z, n_tile_rows, M, K, N,
#: bm, bk, tm, tn, a_dtype, b_dtype, stream)
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 10 + \
    (ctypes.c_void_p,)
#: the kernel's dtype codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DEFAULT_BM = DEFAULT_BK = DEFAULT_BN = 128


def compact_tiles(a: np.ndarray, bm: int = 128, bk: int = 128
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compact the nonzero (bm x bk) tiles of ``a``.

    Returns (a_tiles [T, bm, bk], rows [T], cols [T]) sorted by
    (row, col), padded so every tile-row appears at least once (zero
    tile at col 0) -- guaranteeing each output block is initialized.
    """
    a = np.asarray(a)
    m, k = a.shape
    assert m % bm == 0 and k % bk == 0
    nr, nc = m // bm, k // bk
    tiles, rows, cols = [], [], []
    for i in range(nr):
        row_tiles = 0
        for j in range(nc):
            t = a[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk]
            if np.any(t != 0):
                tiles.append(t)
                rows.append(i)
                cols.append(j)
                row_tiles += 1
        if row_tiles == 0:                      # keep output block defined
            tiles.append(np.zeros((bm, bk), a.dtype))
            rows.append(i)
            cols.append(0)
    return (np.stack(tiles), np.asarray(rows, np.int32),
            np.asarray(cols, np.int32))


def _check(a_tiles: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
           b: torch.Tensor, m: int) -> None:
    if a_tiles.dim() != 3 or b.dim() != 2 or rows.shape != cols.shape or \
            rows.shape != a_tiles.shape[:1]:
        raise ValueError(f"block_sparse_matmul: want a_tiles [T, bm, bk], "
                         f"rows and cols [T], b [K, N]; got "
                         f"{tuple(a_tiles.shape)}, {tuple(rows.shape)}, "
                         f"{tuple(cols.shape)}, {tuple(b.shape)}")
    if a_tiles.dtype not in _DTYPES or b.dtype not in _DTYPES:
        raise ValueError(f"block_sparse_matmul: a_tiles and b must be "
                         f"float32 or bfloat16, got {a_tiles.dtype}, "
                         f"{b.dtype}")
    if rows.dtype.is_floating_point or cols.dtype.is_floating_point:
        raise ValueError("block_sparse_matmul: rows and cols must be "
                         "integer tile indices")
    if m < 0 or min(a_tiles.shape[1:]) <= 0:
        raise ValueError(f"block_sparse_matmul: m {m}, tiles "
                         f"{tuple(a_tiles.shape)}")
    for name, t in (("rows", rows), ("cols", cols), ("b", b)):
        if t.device != a_tiles.device:
            raise ValueError(f"block_sparse_matmul: a_tiles on "
                             f"{a_tiles.device}, {name} on {t.device}")


def block_sparse_matmul_plain(a_tiles: torch.Tensor, rows: torch.Tensor,
                              cols: torch.Tensor, b: torch.Tensor,
                              m: int) -> torch.Tensor:
    """Z [m, N] float32: every tile's product with its B block
    (``bmm`` over the tile list), added into its tile-row
    (``index_add_``).  Rows past ``m`` and the ragged K edge are
    zero-padded, as the Pallas BlockSpecs pad them."""
    T, bm, bk = a_tiles.shape
    K, N = b.shape
    n_row = -(-m // bm)
    n_col = max(-(-K // bk), int(cols.max()) + 1 if T else 0)
    bp = F.pad(b.float(), (0, 0, 0, n_col * bk - K))
    prods = torch.bmm(a_tiles.float(), bp.view(n_col, bk, N)[cols.long()])
    z = torch.zeros(n_row, bm, N, dtype=torch.float32, device=b.device)
    z.index_add_(0, rows.long(), prods)
    return z.view(n_row * bm, N)[:m]


def block_sparse_matmul(a_tiles: torch.Tensor, rows: torch.Tensor,
                        cols: torch.Tensor, b: torch.Tensor, m: int,
                        bn: int = DEFAULT_BN) -> torch.Tensor:
    """``block_sparse_matmul_plain``'s function; on a CUDA device, one
    launch of the hand-written kernel (counted on
    ``block_sparse_matmul.launches``).

    a_tiles: [T, bm, bk] tiles sorted by (row, col), as ``compact_tiles``
    gives them; rows, cols: [T] tile indices; b: [K, N]; ``m`` the rows
    of A.  ``bn``, the Pallas kernel's column block, is kept for its
    signature: the CUDA kernel takes 128 columns a CTA and masks the
    ragged edge.  fp32 operands go through 3xTF32 tensor-core products
    (two passes when the other operand is bf16), bf16 x bf16 through one
    pass of bf16 products (see the kernel's note); a tile-row that has no
    tile comes out zero."""
    _check(a_tiles, rows, cols, b, m)
    if a_tiles.device.type == "cpu":
        return block_sparse_matmul_plain(a_tiles, rows, cols, b, m)
    if a_tiles.device.type != "cuda":
        raise ValueError(f"block_sparse_matmul: no kernel for device "
                         f"{a_tiles.device}")
    T, bm, bk = a_tiles.shape
    K, N = b.shape
    n_row = -(-m // bm)
    z = torch.empty((m, N), dtype=torch.float32, device=b.device)
    if z.numel() == 0:
        return z
    rows = rows.to(torch.int64)
    # CSR over the sorted tile rows: tile-row r owns [rowptr[r], rowptr[r+1])
    rowptr = torch.searchsorted(rows, torch.arange(
        n_row + 1, dtype=torch.int64, device=rows.device))
    a_tiles, b = a_tiles.contiguous(), b.contiguous()
    cols = cols.to(torch.int64).contiguous()
    fn = build.function("block_sparse_matmul", "repro_block_sparse_matmul",
                        _ARGTYPES)
    stream = torch.cuda.current_stream(b.device).cuda_stream
    block_sparse_matmul.launches += 1
    build.check("block_sparse_matmul", fn(
        a_tiles.data_ptr(), rowptr.data_ptr(), cols.data_ptr(), b.data_ptr(),
        z.data_ptr(), n_row, m, K, N, bm, bk, 128 if bm % 128 == 0 else 64,
        128, _DTYPES[a_tiles.dtype], _DTYPES[b.dtype], stream))
    return z


block_sparse_matmul.launches = 0


def block_sparse_matmul_dense_a(a: np.ndarray, b: torch.Tensor,
                                bm: int = DEFAULT_BM, bk: int = DEFAULT_BK,
                                bn: int = DEFAULT_BN) -> torch.Tensor:
    """Convenience: compact a dense-with-zero-tiles A (host numpy), move
    the tiles to ``b``'s device, then multiply."""
    tiles, rows, cols = compact_tiles(np.asarray(a), bm, bk)
    if tiles.dtype == np.float64:       # as JAX takes it, without x64
        tiles = tiles.astype(np.float32)
    dev = b.device
    return block_sparse_matmul(torch.from_numpy(tiles).to(dev),
                               torch.from_numpy(rows).to(dev),
                               torch.from_numpy(cols).to(dev), b,
                               m=a.shape[0], bn=bn)
