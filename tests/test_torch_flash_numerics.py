"""The fp32 ``flash_attention`` kernel's arithmetic, emulated on the CPU.

The fp32 route of ``csrc/flash_attention.cu`` (namespace ``wg32``) runs
both products on the TF32 tensor cores (wgmma) as 3xTF32: every fp32
operand x
(q, k, the softmax weights p and v) goes as hi = tf32(x) and lo = tf32(x
- hi), each rounded to nearest with ties away from zero, and a b is
taken as al bh + ah bl + ah bh (al bl is dropped); TF32 products are
exact in fp32, so the emulation multiplies the parts in fp32 and sums in
fp32.  Around the products it keeps the kernel's online softmax over its
key tiles (64 keys, 32 at head dim 128): scores scaled by log2(e) /
sqrt(d) in fp32, masked keys at -1e30, a running max m and sum l and the
output rescaled by 2^(m_old - m_new) a tile, p = 2^(x - m) with
``ex2.approx`` (within 2 ulp: each weight is perturbed by 2^-22 with a
random sign), and the division by l at the end.

The emulation is held to the reference's oracle
(``repro.kernels.ref.attention_ref``, fp32) within a quarter of the
limit the kernel is held to on the card (``chip_smoke.FLASH_ATOL`` for
fp32, 2e-5) on the reference's ``ATTN_SHAPES`` causal and not, its
ragged case and Whisper-small's four attention calls at batch 1.  The
route needs three passes: one TF32 pass misses the limit on every one of
these shapes, which is why the kernel splits every operand.  Inputs are
standard normal, made with numpy from a seed, as the reference test and
``chip_smoke._attn_inputs`` make them.

The tensor cores also truncate as they accumulate (round toward zero).
Over Whisper's 1500 frames, with values that share a mean as the
encoder's do, that bias compounds if O itself is the accumulator of every
tile's P V; the kernel gives each tile a fresh accumulator and adds it to
O with a rounding FMA.  ``emulate_accumulation`` models both.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from test_torch_bsmm_numerics import split, tf32

#: the kernel's limit on the card (chip_smoke.FLASH_ATOL[float32])
FLASH_ATOL = 2e-5
#: (b, h, hkv, sq, sk, d): the reference's ATTN_SHAPES (tests/test_kernels.py)
ATTN_SHAPES = [(1, 2, 2, 128, 128, 64), (2, 4, 2, 256, 256, 64),
               (1, 8, 1, 128, 256, 32), (2, 2, 2, 64, 192, 128)]
#: the reference's ragged-tail case, non-causal (sk below one key tile)
ATTN_RAGGED = (1, 1, 1, 64, 40, 32)
#: Whisper-small's calls at batch 1, ((b, h, hkv, sq, sk, d), causal): the
#: encoder, the decoder's self- and cross-attention, decode's one query
WHISPER = [((1, 12, 12, 1500, 1500, 64), False),
           ((1, 12, 12, 448, 448, 64), True),
           ((1, 12, 12, 448, 1500, 64), False),
           ((1, 12, 12, 1, 1500, 64), False)]
CASES = [(s, c) for s in ATTN_SHAPES for c in (True, False)] \
    + [(ATTN_RAGGED, False)] + WHISPER
NEG = -1e30
LOG2E = 1.4426950408889634


def key_tile(d: int) -> int:
    """Keys per tile of the fp32 kernel (``Cfg<D>::kBk``)."""
    return 32 if d == 128 else 64


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b on the TF32 tensor cores: ``passes`` 3 is al bh + ah bl +
    ah bh, 1 is ah bh; fp32 products, fp32 sums."""
    if passes == 1:
        return tf32(a) @ tf32(b)
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def ex2(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """2^x in fp32, off by 2 ulp (2^-22) with a random sign, the bound of
    ``ex2.approx.ftz.f32``."""
    sign = torch.randint(0, 2, x.shape, generator=gen).double() * 2 - 1
    y = torch.exp2(x.double()).float().double() * (1 + sign * 2.0 ** -22)
    return y.float()


def emulate(q, k, v, causal: bool, passes: int, seed: int = 0):
    """The kernel's fp32 route on q [b, h, sq, d], k, v [b, hkv, sk, d]
    (numpy fp32): key tiles in order, the online softmax carry in fp32."""
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    b, h, sq, d = q.shape
    group = h // k.shape[1]
    k, v = (x.repeat_interleave(group, dim=1) for x in (k, v))
    sk, bk = k.shape[2], key_tile(d)
    scale = np.float32(LOG2E / math.sqrt(d))
    gen = torch.Generator().manual_seed(seed)
    m = torch.full((b, h, sq, 1), NEG)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, d)
    rows = torch.arange(sq)[:, None]
    for j0 in range(0, sk, bk):
        kt, vt = k[:, :, j0:j0 + bk], v[:, :, j0:j0 + bk]
        x = product(q, kt.transpose(-1, -2), passes) * scale
        cols = j0 + torch.arange(kt.shape[2])[None, :]
        if causal:
            x = torch.where(cols > rows, NEG, x)
        mn = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = ex2(m - mn, gen)
        p = ex2(x - mn, gen)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + product(p, vt, passes)
        m = mn
    return torch.where(l == 0, 0.0, acc / l)


def _inputs(shape, seed=0):
    b, h, hkv, sq, sk, d = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s, dtype=np.float32)
                 for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))


def _oracle(q, k, v, causal):
    return torch.from_numpy(np.array(ref.attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)))


def test_product_passes_carry_their_accuracy():
    """Three passes leave about 2^-21 of |a| |b| per term, one 2^-11."""
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.standard_normal((64, 64), dtype=np.float32))
            for _ in range(2))
    exact = a.double() @ b.double()
    norm = a.double().abs() @ b.double().abs()
    three = ((product(a, b, 3).double() - exact).abs() / norm).max()
    one = ((product(a, b, 1).double() - exact).abs() / norm).max()
    assert float(three) < 2.0 ** -20 and float(one) > 2.0 ** -13


@pytest.mark.parametrize("case", CASES, ids=str)
def test_three_tf32_passes_hold_the_card_limit(case):
    shape, causal = case
    q, k, v = _inputs(shape)
    want = _oracle(q, k, v, causal)
    got = emulate(q, k, v, causal, passes=3)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= FLASH_ATOL / 4


@pytest.mark.parametrize("case", CASES, ids=str)
def test_one_tf32_pass_misses_the_card_limit(case):
    """One pass rounds q, k, p and v to 10 mantissa bits: scores off by
    about 2^-11 of |q| |k|, outputs by more than the limit."""
    shape, causal = case
    q, k, v = _inputs(shape)
    err = float((emulate(q, k, v, causal, passes=1)
                 - _oracle(q, k, v, causal)).abs().max())
    assert err > FLASH_ATOL



def _rz(x: torch.Tensor) -> torch.Tensor:
    """fp64 to fp32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def tc_product(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    """acc + a @ b as 3xTF32 wgmma steps: each k8 step's al bh, ah bl and
    ah bh summed exactly and added to the fp32 accumulator toward zero."""
    ah, al = split(a)
    bh, bl = split(b)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = _rz(acc.double() + x[..., k0:k0 + 8].double()
                      @ y[..., k0:k0 + 8, :].double())
    return acc


def emulate_accumulation(q, k, v, per_tile: bool, seed: int = 0):
    """``emulate`` (non-causal) with truncating accumulation: S a fresh
    accumulator a tile, and P V into a fresh accumulator added to O by a
    rounding FMA (``per_tile``, the kernel) or into O itself."""
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    b, h, sq, d = q.shape
    bk, scale = key_tile(d), np.float32(LOG2E / math.sqrt(d))
    gen = torch.Generator().manual_seed(seed)
    m = torch.full((b, h, sq, 1), NEG)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, d)
    for j0 in range(0, k.shape[2], bk):
        kt, vt = k[:, :, j0:j0 + bk], v[:, :, j0:j0 + bk]
        x = tc_product(torch.zeros(b, h, sq, kt.shape[2]), q,
                       kt.transpose(-1, -2)) * scale
        mn = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha, p = ex2(m - mn, gen), ex2(x - mn, gen)
        l = l * alpha + p.sum(-1, keepdim=True)
        if per_tile:
            pv = tc_product(torch.zeros_like(acc), p, vt)
            acc = (acc.double() * alpha.double() + pv.double()).float()
        else:
            acc = tc_product(acc * alpha, p, vt)
        m = mn
    return acc / l


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("per_tile", [True, False], ids=["tile", "chained"])
def test_per_tile_accumulation_holds_values_with_a_shared_mean(seed,
                                                               per_tile):
    """Whisper's decoder over 1500 frames, d 64, values offset by 2.5: a
    fresh accumulator a tile holds a quarter of the limit; O as the
    tensor cores' accumulator over all 24 tiles misses the limit."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, 2, 128, 64), dtype=np.float32)
    k = rng.standard_normal((1, 2, 1500, 64), dtype=np.float32)
    v = (rng.standard_normal((1, 2, 1500, 64)) + 2.5).astype(np.float32)
    want = _oracle(q, k, v, False)
    err = float((emulate_accumulation(q, k, v, per_tile) - want).abs().max())
    if per_tile:
        assert err <= FLASH_ATOL / 4
    else:
        assert err > FLASH_ATOL
