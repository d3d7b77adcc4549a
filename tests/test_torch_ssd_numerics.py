"""The bf16 ``ssd_chunk`` kernel's arithmetic, emulated on the CPU.

The tensor-core kernel (``csrc/ssd_chunk.cu``, namespace ``tc``) computes
G = C B^T from bf16 inputs with fp32 sums, S = G o L in fp32 with
``__expf`` (ex2.approx of e log2 e), splits S into three bf16 parts and
multiplies each with the bf16 X on one fp32 accumulator.  This file
emulates those steps in torch and holds the emulation to
``ssd_chunk_plain`` at the tolerance the kernel is held to on the card
(``chip_smoke.SSD_TOL``, the card tests' 2e-4): |got - want| <= 2e-4
(1 + |want|).  One bf16 rounding of S does not pass, which is why the
kernel splits S three ways.  The inputs are made with numpy from a
seed, as ``chip_smoke._ssd_inputs`` makes them on the card (standard
normal x, b, c in bf16; a = -0.1 |normal|, or uniform in (-5, 0] for
strong decay).

The fp32 route (namespace ``tc32``) takes both products on the TF32
tensor cores as 3xTF32: each fp32 operand (C, B, then S and X) goes as
hi = tf32(x) and lo = tf32(x - hi) and a product as al bh + ah bl + ah bh
(``tests/test_torch_bsmm_numerics.py`` has the rounding).  Its emulation
is held to the same tolerance on fp32 inputs: three passes hold it, and
any fewer (one TF32 pass, or two that leave one operand of each product
rounded once) miss it, so the kernel needs three passes on both G and Y.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_chunk_plain
from test_torch_bsmm_numerics import split, tf32

#: the kernel's tolerance: chip_smoke.SSD_TOL, tests/test_torch_cuda.py
SSD_TOL = 2e-4
#: (B, nc, l, H, P, N): the reference's SSD_SHAPES, then Mamba2-1.3B's
#: heads, head dim and state at one chunk length
SHAPES = [(1, 2, 64, 2, 32, 16), (2, 3, 128, 4, 64, 32),
          (1, 1, 256, 8, 64, 128), (1, 2, 256, 64, 64, 128)]
#: strong decay: the card tests' SSD_DECAY_CASES at one batch
DECAY_SHAPES = [(1, 2, 256, 8, 64, 128), (1, 1, 100, 3, 24, 40)]
#: one ulp of an fp32 in [1, 2), relative
ULP = 2.0 ** -23


def _inputs(shape, seed=3, strong=False, dtype=torch.bfloat16):
    B, nc, l, H, P, N = shape
    rng = np.random.default_rng(seed)

    def normal(*s):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32))

    x = normal(B, nc, l, H, P).to(dtype)
    if strong:
        a = torch.from_numpy(-5 * rng.random((B, H, nc, l), dtype=np.float32))
    else:
        a = -normal(B, H, nc, l).abs() * 0.1
    return x, a, normal(B, nc, l, N).to(dtype), normal(B, nc, l, N).to(dtype)


def _split(s, parts):
    """S as ``parts`` bf16 terms, each the rounding of what the ones
    before it left (the differences are exact in fp32)."""
    out, rest = [], s
    for _ in range(parts):
        p = rest.bfloat16().float()
        out.append(p)
        rest = rest - p
    return out


def _decay(a, seed):
    """L as both kernels take it: cum in fp64 rounded once; e^x rounded
    to fp32, then off by +-(2 + floor(|1.16 x|)) ulp with random signs
    (the CUDA programming guide's bound for ``__expf``); 0 above the
    diagonal."""
    cum = torch.cumsum(a.double(), -1).float()
    e = cum[..., :, None] - cum[..., None, :]                 # fp32
    l = a.shape[-1]
    keep = torch.ones(l, l, dtype=torch.bool).tril()
    gen = torch.Generator().manual_seed(seed)
    sign = torch.randint(0, 2, e.shape, generator=gen).double() * 2 - 1
    arg = torch.where(keep, e, 0.0).double()
    rel = (2 + torch.floor(1.16 * arg.abs())) * ULP
    decay = torch.exp(arg).float().double() * (1 + sign * rel)
    return torch.where(keep, decay.float(), 0.0)


def emulate(x, a, b, c, parts, seed=0):
    """The kernel's bf16 path: L as ``_decay`` takes it; G and the
    products in fp32."""
    decay = _decay(a, seed)
    g = torch.einsum("bcln,bcsn->bcls", c.float(), b.float())
    s = decay * g[:, None]                                    # fp32
    return sum(torch.einsum("bhcls,bcshp->bclhp", p, x.float())
               for p in _split(s, parts))


def tf32_product(u, w, passes):
    """u @ w on the TF32 tensor cores, fp32 products and sums: ``passes``
    3 is ul wh + uh wl + uh wh; 2 drops one of the cross terms ("u": w is
    rounded once, "w": u is); 1 is uh wh."""
    uh, ul = split(u)
    wh, wl = split(w)
    terms = {3: [(ul, wh), (uh, wl)], "u": [(ul, wh)], "w": [(uh, wl)],
             1: []}[passes]
    return sum((p @ q for p, q in terms), uh @ wh)


def emulate_tf32(x, a, b, c, passes, seed=0):
    """The kernel's fp32 path: L as ``_decay`` takes it; G = C B^T and Y
    = S X, S = G o L in fp32, each product in ``passes``."""
    decay = _decay(a, seed)
    g = tf32_product(c, b.transpose(-1, -2), passes)          # [B,nc,l,s]
    s = decay * g[:, None]                                    # [B,H,nc,l,s]
    y = tf32_product(s, x.permute(0, 3, 1, 2, 4), passes)     # [B,H,nc,l,P]
    return y.permute(0, 2, 3, 1, 4)


def _worst(got, want):
    """The largest |got - want| as a share of its limit."""
    return float(((got - want).abs() / (SSD_TOL * (1 + want.abs()))).max())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_three_way_split_holds_the_tolerance(shape):
    x, a, b, c = _inputs(shape)
    want = ssd_chunk_plain(x, a, b, c)
    assert _worst(emulate(x, a, b, c, parts=3), want) < 0.5
    # one bf16 rounding of S misses it many times over
    assert _worst(emulate(x, a, b, c, parts=1), want) > 10


@pytest.mark.parametrize("shape", DECAY_SHAPES, ids=str)
def test_three_way_split_holds_under_strong_decay(shape):
    """Decay down to exp(-5) a step: most of L underflows at l 256."""
    x, a, b, c = _inputs(shape, seed=4, strong=True)
    want = ssd_chunk_plain(x, a, b, c)
    got = emulate(x, a, b, c, parts=3)
    assert bool(torch.isfinite(got).all())
    assert _worst(got, want) < 0.5


def test_plain_cumsum_is_rounded_once():
    """The plain version's cum is the fp64 sum rounded once, so an fp32
    scan in another order (the kernel's warps, a GPU's cumsum) cannot
    move it; under strong decay such a scan alone would cost more than
    the tolerance."""
    x, a, b, c = _inputs((1, 1, 256, 8, 64, 128), seed=4, strong=True)
    want = ssd_chunk_plain(x, a, b, c)
    # the same function with cum summed left to right in fp32
    cum32 = torch.from_numpy(np.cumsum(a.numpy(), -1, dtype=np.float32))
    l = a.shape[-1]
    keep = torch.ones(l, l, dtype=torch.bool).tril()
    e = cum32[..., :, None] - cum32[..., None, :]
    decay = torch.where(keep, torch.exp(torch.where(keep, e, 0.0).double())
                        .float(), 0.0)
    g = torch.einsum("bcln,bcsn->bcls", c.float(), b.float())
    seq = torch.einsum("bhcls,bcshp->bclhp", decay * g[:, None], x.float())
    assert _worst(seq, want) > 1


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_three_tf32_passes_hold_the_tolerance(shape):
    """The fp32 route on fp32 inputs: 3xTF32 on G and Y."""
    x, a, b, c = _inputs(shape, dtype=torch.float32)
    want = ssd_chunk_plain(x, a, b, c)
    assert _worst(emulate_tf32(x, a, b, c, passes=3), want) < 0.5


@pytest.mark.parametrize("shape", DECAY_SHAPES, ids=str)
def test_three_tf32_passes_hold_under_strong_decay(shape):
    x, a, b, c = _inputs(shape, seed=4, strong=True, dtype=torch.float32)
    want = ssd_chunk_plain(x, a, b, c)
    got = emulate_tf32(x, a, b, c, passes=3)
    assert bool(torch.isfinite(got).all())
    assert _worst(got, want) < 0.5


@pytest.mark.parametrize("passes", [1, "u", "w"], ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fewer_tf32_passes_miss_the_tolerance(shape, passes):
    """One pass, or two that round one operand of every product once,
    leave errors of 2^-11 of a term: over the tolerance where y is small,
    so the kernel takes three passes."""
    x, a, b, c = _inputs(shape, dtype=torch.float32)
    want = ssd_chunk_plain(x, a, b, c)
    assert _worst(emulate_tf32(x, a, b, c, passes=passes), want) > 1
