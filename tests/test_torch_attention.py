"""The port's flash-attention and block-sparse-matmul modules against the
reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages (bf16
inputs are rounded once, by JAX, and carried bit for bit).  On the CPU
the port's wrappers take their plain versions; the reference's Pallas
kernels run in interpret mode, as its own tests run them.

Tolerances are the reference's own (tests/test_kernels.py): attention
2e-6 in fp32 and 2e-2 in bf16 (one output rounding), block-sparse
matmul 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash

from repro_torch.carry import tensor_from_array
from repro_torch.kernels import (block_sparse_matmul,
                                 block_sparse_matmul_dense_a,
                                 block_sparse_matmul_plain, compact_tiles,
                                 flash_attention, flash_attention_plain)
from repro_torch.kernels import ref as tref

#: (b, h, hkv, sq, sk, d), the reference's ATTN_SHAPES
ATTN_SHAPES = [
    (1, 2, 2, 128, 128, 64),       # MHA square
    (2, 4, 2, 256, 256, 64),       # GQA 2:1
    (1, 8, 1, 128, 256, 32),       # MQA, sk > sq
    (2, 2, 2, 64, 192, 128),       # blocks > sq (clamped)
]
ATOL = {"float32": 2e-6, "bfloat16": 2e-2}
#: (M, K, N, bm, bk, bn, tile density), the reference's BSMM_SHAPES
BSMM_SHAPES = [
    (128, 128, 128, 64, 64, 64, 0.5),
    (256, 128, 192, 64, 64, 64, 0.3),
    (256, 256, 64, 128, 128, 64, 0.2),
    (128, 256, 128, 64, 128, 128, 0.0),     # fully-empty A
]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t).astype(np.float32)


def _both(arrays, dtype: str):
    """The same values as JAX arrays and as tensors (rounded once)."""
    js = [jnp.asarray(a, dtype) for a in arrays]
    return js, [tensor_from_array(np.asarray(j)) for j in js]


def _attn_inputs(b, h, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in
            ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


@pytest.mark.parametrize("b,h,hkv,sq,sk,d", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_reference(b, h, hkv, sq, sk, d, dtype,
                                                 causal):
    (qj, kj, vj), (qt, kt, vt) = _both(
        _attn_inputs(b, h, hkv, sq, sk, d), dtype)
    got = flash_attention_plain(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    kernel = jax_flash(qj, kj, vj, causal=causal, block_q=64, block_k=64,
                       interpret=True)
    oracle = jref.attention_ref(qj, kj, vj, causal=causal)
    np.testing.assert_allclose(_np(got), _np(kernel), atol=ATOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), atol=ATOL[dtype])
    # the port's oracle is the same function
    np.testing.assert_array_equal(
        _np(tref.attention_ref(qt, kt, vt, causal)), _np(got))


def test_flash_attention_fully_masked_rows():
    """Non-causal with sk below one block: the ragged tail gives no NaN,
    and the port agrees with the reference kernel."""
    (qj, kj, vj), (qt, kt, vt) = _both(
        _attn_inputs(1, 1, 1, 64, 40, 32, seed=1), "float32")
    got = flash_attention(qt, kt, vt, causal=False)
    assert bool(torch.isfinite(got).all())
    want = jax_flash(qj, kj, vj, causal=False, block_q=32, block_k=32,
                     interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL["float32"])


def test_flash_attention_wrapper_on_cpu_takes_plain():
    _, (q, k, v) = _both(_attn_inputs(1, 4, 2, 16, 16, 32), "float32")
    flash_attention.launches = 0
    assert torch.equal(flash_attention(q, k, v), flash_attention_plain(q, k, v))
    # [b, s, h, d] projections passed as [b, h, s, d] views, as mha does
    qs = q.transpose(1, 2).contiguous()
    assert torch.equal(flash_attention(qs.transpose(1, 2), k, v),
                       flash_attention_plain(q, k, v))
    # the meta device (a dry run's route): an empty output of q's shape
    # and dtype, no launch and no plain version
    out = flash_attention(*(t.to("meta") for t in (q, k, v)))
    assert (out.device.type, out.shape, out.dtype) == ("meta", q.shape,
                                                       q.dtype)
    assert flash_attention.launches == 0
    with pytest.raises(ValueError, match="divide"):
        flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="want q"):
        flash_attention(q, k, v[..., :16])
    assert flash_attention.launches == 0


def _bf16_kernel_emulated(q, k, v, causal: bool, tile: int = 128):
    """The bf16 CUDA kernel's arithmetic in float32 torch: 128-key tiles,
    a running max, P = exp(s - m) rounded to bf16 for the PV product, l
    summing the unrounded weights, and the division by l at the end.
    (The kernel skips the tiles past a causal block's last query; their
    weights are exactly 0 here.)"""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, h // hkv, sq, d)
    m = torch.full((b, hkv, h // hkv, sq, 1), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    rows = torch.arange(sq)[:, None]
    for j0 in range(0, sk, tile):
        kt, vt = k[:, :, j0:j0 + tile].float(), v[:, :, j0:j0 + tile].float()
        s = torch.einsum("bkgqd,bksd->bkgqs", qf, kt) / d ** 0.5
        if causal:
            cols = torch.arange(j0, j0 + kt.shape[2])[None, :]
            s = s.masked_fill(cols > rows, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(torch.isinf(m_new), 0.0, m_new)
        alpha, p = torch.exp(m - base), torch.exp(s - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bkgqs,bksd->bkgqd", p.bfloat16().float(), vt)
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)
    return out.reshape(b, h, sq, d).to(q.dtype)


@pytest.mark.parametrize("b,h,hkv,sq,sk,d", ATTN_SHAPES + [
    (1, 28, 4, 256, 256, 128)], ids=str)        # Qwen2-7B's heads, short
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_kernel_numerics_within_tolerance(b, h, hkv, sq, sk, d, causal):
    """Rounding the softmax weights to bf16 for the tensor-core PV
    product keeps the kernel within the reference's bf16 tolerance (2e-2)
    of the plain version (PV in fp32) and of the Pallas kernel in
    interpret mode."""
    (qj, kj, vj), (qt, kt, vt) = _both(
        _attn_inputs(b, h, hkv, sq, sk, d, seed=6), "bfloat16")
    torch.exp(torch.rand(1 << 22))     # warm-up: see tests/test_torch_ssm.py
    got = _bf16_kernel_emulated(qt, kt, vt, causal)
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    plain = flash_attention_plain(qt, kt, vt, causal=causal)
    kernel = jax_flash(qj, kj, vj, causal=causal, block_q=128, block_k=128,
                       interpret=True)
    np.testing.assert_allclose(_np(got), _np(plain), atol=ATOL["bfloat16"])
    np.testing.assert_allclose(_np(got), _np(kernel), atol=ATOL["bfloat16"])
    # the rounding of P is really there: fp32 weights land elsewhere
    assert not torch.equal(got, plain)


# ---------------------------------------------------------------------- #
# block-sparse matmul
# ---------------------------------------------------------------------- #
def _bsmm_inputs(M, K, N, bm, bk, density, seed=2):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    mask = rng.random((M // bm, K // bk)) < density
    a = a * np.kron(mask, np.ones((bm, bk), np.float32))
    return a, rng.standard_normal((K, N)).astype(np.float32)


@pytest.mark.parametrize("M,K,N,bm,bk,bn,density", BSMM_SHAPES)
def test_block_sparse_matmul_matches_reference(M, K, N, bm, bk, bn, density):
    a, b = _bsmm_inputs(M, K, N, bm, bk, density)
    tiles, rows, cols = compact_tiles(a, bm, bk)
    rtiles, rrows, rcols = ops.compact_tiles(a, bm, bk)
    np.testing.assert_array_equal(tiles, rtiles)
    np.testing.assert_array_equal(rows, rrows)
    np.testing.assert_array_equal(cols, rcols)
    assert rows.dtype == rrows.dtype and cols.dtype == rcols.dtype
    tt = [torch.from_numpy(x) for x in (tiles, rows, cols)]
    got = block_sparse_matmul_plain(*tt, torch.from_numpy(b), M)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    want = ops.block_sparse_matmul_dense_a(a, jnp.asarray(b), bm, bk, bn)
    oracle = jref.block_sparse_matmul_ref(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=1e-4)
    block_sparse_matmul.launches = 0
    dense_a = block_sparse_matmul_dense_a(a, torch.from_numpy(b), bm, bk, bn)
    assert torch.equal(dense_a, got)
    assert block_sparse_matmul.launches == 0
    np.testing.assert_array_equal(
        _np(tref.block_sparse_matmul_ref(torch.from_numpy(a),
                                         torch.from_numpy(b))),
        _np(torch.from_numpy(a) @ torch.from_numpy(b)))


def test_compact_tiles_covers_all_rows():
    a = np.zeros((256, 128))
    a[130, 5] = 1.0                          # only tile-row 2 nonzero
    tiles, rows, cols = compact_tiles(a, 64, 64)
    assert set(rows.tolist()) == {0, 1, 2, 3}  # every row covered
    assert sum(np.any(t != 0) for t in tiles) == 1
    b = torch.ones(128, 8)
    z = block_sparse_matmul_dense_a(a, b, 64, 64, 8)
    assert z.dtype == torch.float32          # float64 A is taken as fp32
    assert torch.equal(z, torch.from_numpy(a).float() @ b)


def test_tile_mask_matches_reference():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((96, 64)) * (rng.random((96, 64)) < 0.01)
    np.testing.assert_array_equal(tref.tile_mask(a, 32, 32),
                                  jref.tile_mask(a, 32, 32))


def test_block_sparse_matmul_wrapper_on_cpu():
    """Tile lists that skip tile-rows or pad K raggedly: the plain
    version zero-pads as the Pallas BlockSpecs do; bad inputs raise."""
    rng = np.random.default_rng(4)
    tiles = torch.from_numpy(rng.standard_normal((3, 32, 16))
                             .astype(np.float32))
    rows, cols = torch.tensor([0, 0, 2]), torch.tensor([0, 2, 1])
    b = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32))
    z = block_sparse_matmul(tiles, rows, cols, b, m=96)
    bp = torch.cat([b, torch.zeros(8, 24)])
    want = torch.zeros(96, 24)
    for t, r, c in zip(tiles, rows, cols):
        want[32 * r:32 * r + 32] += t @ bp[16 * c:16 * c + 16]
    torch.testing.assert_close(z, want, rtol=0, atol=1e-5)
    assert bool((z[32:64] == 0).all())
    zb = block_sparse_matmul(tiles.bfloat16(), rows, cols, b.bfloat16(), 96)
    assert zb.dtype == torch.float32
    # the meta device (a dry run's route): an empty fp32 Z, no launch
    block_sparse_matmul.launches = 0
    zm = block_sparse_matmul(*(t.to("meta") for t in (tiles, rows, cols, b)),
                             m=96)
    assert (zm.device.type, zm.shape, zm.dtype) == ("meta", (96, 24),
                                                    torch.float32)
    assert block_sparse_matmul.launches == 0
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        block_sparse_matmul(tiles.double(), rows, cols, b, m=96)
    with pytest.raises(ValueError, match="want a_tiles"):
        block_sparse_matmul(tiles, rows[:2], cols, b, m=96)
    with pytest.raises(ValueError, match="integer"):
        block_sparse_matmul(tiles, rows.float(), cols, b, m=96)
