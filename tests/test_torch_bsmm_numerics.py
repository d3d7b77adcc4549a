"""The ``block_sparse_matmul`` kernel's TF32 arithmetic, emulated on the
CPU.

On the card an fp32 operand x goes to the TF32 tensor cores as two parts,
hi = tf32(x) and lo = tf32(x - hi), each rounded to nearest with ties away
from zero (the rounding of ``cvt.rna.tf32.f32``, which the kernel computes
with the same two integer operations as ``tf32`` below), and a b is taken
as al bh + ah bl + ah bh (3xTF32; al bl is dropped).  A bf16 operand is exact in TF32 and goes as it
is, so a mixed pair takes two passes and bf16 x bf16 one pass of bf16
products, which are exact.  This file emulates the rounding with integer
operations on the fp32 bits and holds the emulated products to the
reference's oracle (``repro.kernels.ref.block_sparse_matmul_ref``, fp32) at
the reference's own limit, atol 1e-4 (``tests/test_kernels.py``), on the
reference's shapes: three passes hold it, one TF32 pass misses it by about
a hundred times, which is why the kernel splits fp32 operands.  TF32
products are exact in fp32 (11 x 11 significant bits), so the emulation
multiplies the parts in fp32 like the tensor cores and sums in fp32.
Inputs are made with numpy from a seed, as the reference test makes them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import block_sparse_matmul_plain, compact_tiles

#: the reference's atol (tests/test_kernels.py::test_block_sparse_matmul_sweep)
REF_ATOL = 1e-4
#: the card's limit: |err| <= BSMM_RTOL sqrt(K) max |Z| (chip_smoke.py)
BSMM_RTOL = 1e-4
#: (M, K, N, bm, bk, bn, tile density): the reference's BSMM_SHAPES (the
#: fourth with an empty A) and its bench's case
BSMM_SHAPES = [(128, 128, 128, 64, 64, 64, 0.5),
               (256, 128, 192, 64, 64, 64, 0.3),
               (256, 256, 64, 128, 128, 64, 0.2),
               (128, 256, 128, 64, 128, 128, 0.0),
               (256, 256, 128, 64, 64, 64, 0.4)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on fp32 bits, as the kernel computes it: keep
    10 mantissa bits, round to nearest with ties away from zero (add half
    of the dropped 13 bits to the magnitude, then clear them)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def _inputs(shape, seed=2, scale=1.0):
    """The reference test's inputs: standard normal A with whole zero
    tiles at the tile density, standard normal B."""
    M, K, N, bm, bk, _, density = shape
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32) * np.float32(scale)
    a *= np.kron(rng.random((M // bm, K // bk)) < density,
                 np.ones((bm, bk), np.float32))
    b = (rng.standard_normal((K, N)) * scale).astype(np.float32)
    return a, b


#: the shapes whose A has a nonzero tile at the reference test's seed (at
#: density 0.5 the first one draws none)
NONEMPTY = [s for s in BSMM_SHAPES if _inputs(s)[0].any()]


def _oracle(a: np.ndarray, b: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(ref.block_sparse_matmul_ref(
        jnp.asarray(a), jnp.asarray(b))))


def emulate(a: np.ndarray, b: np.ndarray, bm: int, bk: int,
            passes: int) -> torch.Tensor:
    """The kernel's products over A's nonzero tiles: ``passes`` 3 is
    al bh + ah bl + ah bh, 2 is a bh + a bl (A exact in TF32, as a bf16
    A is), 1 is one TF32 pass ah bh."""
    tiles, rows, cols = (torch.from_numpy(x) for x in compact_tiles(a, bm,
                                                                    bk))
    bt = torch.from_numpy(b)
    ah, al = split(tiles)
    bh, bl = split(bt)
    if passes == 2:
        ah, al = tiles, torch.zeros_like(tiles)
    terms = [(ah, bh)] if passes == 1 else [(al, bh), (ah, bl), (ah, bh)]
    return sum(block_sparse_matmul_plain(x, rows, cols, y, a.shape[0])
               for x, y in terms)


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    cases = {one + 2 ** -11: one + 2 ** -10,       # tie: away from zero
             -(one + 2 ** -11): -(one + 2 ** -10),
             one + 2 ** -12: one,                   # below half: down
             one + 3 * 2 ** -12: one + 2 ** -10,    # above half: up
             2 - 2 ** -12: 2.0,                     # carries into exponent
             one + 2 ** -10: one + 2 ** -10,        # already TF32
             0.0: 0.0}
    x = torch.tensor(list(cases), dtype=torch.float32)
    want = torch.tensor(list(cases.values()), dtype=torch.float32)
    assert torch.equal(tf32(x), want)


def test_tf32_keeps_ten_bits_to_half_an_ulp():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(1 << 16)
                          * 10.0 ** rng.integers(-6, 7, 1 << 16))
                         .astype(np.float32))
    r = tf32(x)
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rel = ((r.double() - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -11


def test_split_carries_fp32_to_21_bits():
    """hi + lo is x to 2^-22, and the three-term product a b to 3 2^-22
    (2^-20); one pass leaves about 2^-11 per operand."""
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.standard_normal(1 << 16).astype(np.float32))
            for _ in range(2))
    ah, al = split(a)
    bh, bl = split(b)
    rel = ((ah.double() + al.double() - a.double()).abs()
           / a.double().abs()).max()
    assert float(rel) <= 2.0 ** -22
    exact = a.double() * b.double()
    three = al.double() * bh.double() + ah.double() * bl.double() \
        + ah.double() * bh.double()
    assert float(((three - exact).abs() / exact.abs()).max()) <= 2.0 ** -20
    one = ah.double() * bh.double()
    assert float(((one - exact).abs() / exact.abs()).median()) > 2.0 ** -13


def test_bf16_is_exact_in_tf32():
    """So a bf16 operand needs no lo part: a mixed pair takes two
    passes."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(1 << 16).astype(np.float32)) \
        .bfloat16().float()
    hi, lo = split(x)
    assert torch.equal(hi, x) and int(lo.count_nonzero()) == 0


@pytest.mark.parametrize("shape", BSMM_SHAPES, ids=str)
def test_three_tf32_passes_hold_the_reference_atol(shape):
    M, K, N, bm, bk, bn, _ = shape
    a, b = _inputs(shape)
    want = _oracle(a, b)
    got = emulate(a, b, bm, bk, passes=3)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= REF_ATOL / 2


@pytest.mark.parametrize("shape", NONEMPTY, ids=str)
def test_one_tf32_pass_misses_the_reference_atol(shape):
    """One TF32 pass is off by about 2^-11 per operand: errors of order
    1e-2 at K 128-256, tens of times the reference's atol."""
    M, K, N, bm, bk, bn, _ = shape
    a, b = _inputs(shape)
    err = float((emulate(a, b, bm, bk, passes=1) - _oracle(a, b)).abs().max())
    assert err > 10 * REF_ATOL


@pytest.mark.parametrize("shape", NONEMPTY, ids=str)
@pytest.mark.parametrize("side", ["a_bf16", "b_bf16"])
def test_mixed_pairs_take_two_passes(shape, side):
    """With one operand in bf16 (exact in TF32), two passes on the
    other's split hold the reference's atol."""
    M, K, N, bm, bk, bn, _ = shape
    a, b = _inputs(shape)
    if side == "a_bf16":
        a = torch.from_numpy(a).bfloat16().float().numpy()
        got = emulate(a, b, bm, bk, passes=2)
    else:
        b = torch.from_numpy(b).bfloat16().float().numpy()
        # the split of A on a B that is its own hi part: al b + ah b
        got = emulate(a, b, bm, bk, passes=3)
    assert float((got - _oracle(a, b)).abs().max()) <= REF_ATOL / 2


@pytest.mark.parametrize("shape", NONEMPTY[:2], ids=str)
def test_three_passes_hold_the_card_limit_at_large_values(shape):
    """|values| near 1e4 (products near 1e8): the split is relative, so
    the card's limit, relative to max |Z|, holds as at unit scale."""
    M, K, N, bm, bk, bn, _ = shape
    a, b = _inputs(shape, scale=1e4)
    want = _oracle(a, b)
    err = float((emulate(a, b, bm, bk, passes=3) - want).abs().max())
    assert err <= BSMM_RTOL * K ** 0.5 * float(want.abs().max()) / 10
