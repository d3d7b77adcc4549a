"""The gradient of the port's ``flash_attention``, on the CPU.

``flash_attention_bwd_plain`` (what the backward kernel is held to on
the card) against ``jax.vjp`` of the reference's ``attention_ref``, and
``FlashAttention`` (the autograd Function the card runs) against torch
autograd through the plain forward, with the forward's log-sum-exp
against the reference's scores.  Inputs are seeded numpy arrays, fp32.
Tolerance: 1e-5 of max(1, max |want|) -- fp32 sums of up to a few
hundred terms in another order (the reference's ``attention_ref`` test
allows 2e-6 on outputs; gradients carry two more products).
"""
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import attention_ref

from repro_torch.kernels import (FlashAttention, flash_attention,
                                 flash_attention_bwd,
                                 flash_attention_bwd_plain,
                                 flash_attention_lse_plain,
                                 flash_attention_plain)
from repro_torch.kernels.flash_attention_bwd import (
    ATOL, bwd_err, flash_attention_bwd_scale, fp32_tile)

TOL = 1e-5
#: (b, h, hkv, sq, sk, d): GQA 4:2, MHA, sq != sk with ragged lengths
#: (sk 70 and sq 37 end inside a 64-row tile), d 32 / 64 / 128
CASES = [(2, 4, 2, 48, 48, 32), (1, 4, 2, 37, 70, 64),
         (2, 2, 2, 70, 37, 128), (1, 4, 1, 33, 33, 64)]


def _inputs(shape, seed=0):
    b, h, hkv, sq, sk, d = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                      (b, h, sq, d))]


def _close(got, want):
    want = np.asarray(want, dtype=np.float32)
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", CASES, ids=str)
def test_plain_backward_matches_jax_vjp(shape, causal):
    q, k, v, do = _inputs(shape)
    out, vjp = jax.vjp(lambda a, b, c: attention_ref(a, b, c, causal),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o = flash_attention_plain(tq, tk, tv, causal)
    _close(o, out)
    lse = flash_attention_lse_plain(tq, tk, tv, causal)
    # the log-sum-exp of the reference's masked scores
    b, h, hkv, sq, sk, d = shape
    s = np.einsum("bkgqd,bksd->bkgqs", q.reshape(b, hkv, h // hkv, sq, d),
                  k) / math.sqrt(d)
    if causal:
        s = np.where(np.arange(sq)[:, None] >= np.arange(sk)[None], s,
                     -np.inf)
    m = s.max(-1, keepdims=True)
    ref_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), ref_lse.reshape(b, h, sq),
                               rtol=1e-6, atol=1e-6)
    got = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g, w)
    # the wrapper takes the plain version on the CPU
    for g, w in zip(flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal),
                    got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", CASES, ids=str)
def test_function_matches_autograd_through_plain(shape, causal):
    q, k, v, do = _inputs(shape, seed=1)
    want = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = flash_attention_plain(*want, causal=causal)
    o.backward(torch.from_numpy(do))
    got = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    # under autograd the wrapper is the Function, on the CPU too
    o2 = flash_attention(*got, causal=causal)
    assert type(o2.grad_fn)._forward_cls is FlashAttention
    torch.testing.assert_close(o2, o, rtol=0, atol=0)
    o2.backward(torch.from_numpy(do))
    for g, w in zip(got, want):
        _close(g.grad, w.grad.numpy())


def test_bf16_plain_backward_rounds_once():
    """In bf16 the plain backward computes in fp32 from the bf16 inputs
    and rounds each gradient once: within one bf16 rounding of the fp32
    gradient on the same values (inside the kernel's ATOL)."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs((1, 4, 2, 40, 56, 64), seed=2))
    f = [t.float() for t in (q, k, v, do)]
    lse = flash_attention_lse_plain(q, k, v)
    o = flash_attention_plain(q, k, v)
    got = flash_attention_bwd_plain(q, k, v, o, lse, do)
    want = flash_attention_bwd_plain(f[0], f[1], f[2], o.float(), lse, f[3])
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        err = float((g.float() - w).abs().max())
        assert err <= 2 ** -8 * float(w.abs().max())
        assert bool(((g.float() - w).abs() <= 2 ** -8 * w.abs()).all())


SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc" / "flash_attention_bwd.cu"


def _constant(name: str) -> int:
    """A namespace-level ``constexpr int`` of the kernel's source."""
    return int(re.search(rf"^constexpr int {name} = (\d+);", SRC.read_text(),
                         re.M).group(1))


#: the bf16 kernel's tiles, read from its source: dK and dV sum over query
#: tiles of kBq (each head of the group in turn), dQ over key tiles of kBk
KV_QUERY_TILE, Q_KEY_TILE = _constant("kBq"), _constant("kBk")


def _bwd_bf16_emulated(q, k, v, o, lse, do, causal):
    """The bf16 kernel's arithmetic on the CPU: P and dS in fp32 from the
    bf16 inputs, P rounded to bf16 for dV = P^T dO and dS for dK and dQ;
    dK and dV summed over the group's heads in order and each head's
    query tiles of KV_QUERY_TILE in order, dQ over key tiles of
    Q_KEY_TILE in order, each tile's product in a fresh fp32 accumulator
    added to the running sum; each gradient rounded once to bf16."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.reshape(b, hkv, g, sq, d).float()
    dof = do.reshape(b, hkv, g, sq, d).float()
    kf, vf = k.float(), v.float()
    p = torch.exp(torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
                  - lse.reshape(b, hkv, g, sq, 1))
    if causal:
        p = torch.where(torch.arange(sq)[:, None] >= torch.arange(sk), p,
                        0.0)
    dsum = (dof * o.reshape(b, hkv, g, sq, d).float()).sum(-1, keepdim=True)
    ds = (p * (torch.einsum("bkgqd,bksd->bkgqs", dof, vf) - dsum)
          ).bfloat16().float()
    p = p.bfloat16().float()
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for head in range(g):
        for i0 in range(0, sq, KV_QUERY_TILE):
            t = slice(i0, i0 + KV_QUERY_TILE)
            dv += torch.einsum("bkqs,bkqd->bksd", p[:, :, head, t],
                               dof[:, :, head, t])
            dk += torch.einsum("bkqs,bkqd->bksd", ds[:, :, head, t],
                               qf[:, :, head, t])
    dq = torch.zeros_like(qf)
    for j0 in range(0, sk, Q_KEY_TILE):
        t = slice(j0, j0 + Q_KEY_TILE)
        dq += torch.einsum("bkgqs,bksd->bkgqd", ds[..., t], kf[:, :, t])
    return tuple(t.to(torch.bfloat16) for t in (
        dq.reshape(b, h, sq, d) * scale, dk * scale, dv))


def _bf16_case(shape, causal, seed):
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(shape, seed=seed))
    lse = flash_attention_lse_plain(q, k, v, causal)
    o = flash_attention_plain(q, k, v, causal)
    args = (q, k, v, o, lse, do, causal)
    return args, flash_attention_bwd_plain(*args), \
        flash_attention_bwd_scale(*args)


#: bf16 hold cases: causal with sq = sk (the last keys have one to a few
#: terms each), sq < sk non-causal with a ragged key tail, and GQA at 7:1
#: over several query tiles of each head and key tiles of 128 (sq > sk,
#: both ragged)
HOLD_CASES = [((2, 4, 2, 128, 128, 64), True),
              ((1, 4, 4, 40, 150, 32), False),
              ((1, 7, 1, 290, 200, 128), True)]


@pytest.mark.parametrize("shape,causal", HOLD_CASES, ids=str)
def test_bf16_kernel_rounding_within_atol(shape, causal):
    """The bf16 kernel's roundings (``_bwd_bf16_emulated``) stay inside
    ATOL of each element's terms; the measure sees them (not 0)."""
    for seed in range(3):
        args, want, scale = _bf16_case(shape, causal, seed)
        err = bwd_err(_bwd_bf16_emulated(*args), want, scale)
        assert 0.0 < err <= ATOL[torch.bfloat16], (seed, err)


@pytest.mark.parametrize("dropped", [8, 64, 128])
@pytest.mark.parametrize("shape,causal", HOLD_CASES, ids=str)
def test_dropped_keys_fail_the_bf16_hold(shape, causal, dropped):
    """A backward that stops ``dropped`` keys early (the last keys' dK and
    dV zero, their terms missing from dQ) fails the hold by far, also
    where those keys carry the smallest gradients (causal, sq = sk): the
    last 8 keys, the fp32 route's 64-key tile and the bf16 route's
    128-key block."""
    args, want, scale = _bf16_case(shape, causal, seed=0)
    q, k, v, o, lse, do, _ = args
    sk = k.shape[2] - dropped
    dq, dk, dv = _bwd_bf16_emulated(q, k[:, :, :sk], v[:, :, :sk], o, lse,
                                    do, causal)
    pad = (0, 0, 0, dropped)
    err = bwd_err((dq, torch.nn.functional.pad(dk, pad),
                   torch.nn.functional.pad(dv, pad)), want, scale)
    assert err > 10 * ATOL[torch.bfloat16], err


#: the fp32 route's tiles, read from its source (namespace bf16x3): work
#: items of kItem keys (dK and dV) or queries (dQ); streamed tiles of
#: kTileF128 rows at d 128 and kTileF below (query tiles of dK and dV, key
#: tiles of dQ)
F32_ITEM, F32_TILE, F32_TILE128 = (_constant("kItem"), _constant("kTileF"),
                                   _constant("kTileF128"))


def _parts3(x):
    """fp32 ``x`` as the fp32 route's three bf16 parts (as fp32 values):
    p0 = bf16(x), p1 = bf16(x - p0), p2 = bf16(x - p0 - p1), each
    remainder exact in fp32, each rounding to nearest even."""
    p0 = x.bfloat16().float()
    r = x - p0
    p1 = r.bfloat16().float()
    return p0, p1, (r - p1).bfloat16().float()


#: the route's six passes of a product of three-part operands, by A part
#: and small terms first: (A part, B part)
PASSES3 = ((2, 0), (1, 1), (1, 0), (0, 2), (0, 1), (0, 0))


def _mm3(eq, a, b, passes=PASSES3):
    """``einsum(eq, a, b)`` as the fp32 route takes it: both operands as
    three bf16 parts, the six passes summed in fp32 in the route's order
    (a1 b2, a2 b1 and a2 b2 dropped); or only ``passes``."""
    pa, pb = _parts3(a), _parts3(b)
    out = None
    for i, j in passes:
        term = torch.einsum(eq, pa[i], pb[j])
        out = term if out is None else out + term
    return out


def _bwd_fp32_emulated(q, k, v, o, lse, do, causal, passes=PASSES3):
    """The fp32 kernel's arithmetic on the CPU: every product (S, dP, dV,
    dK, dQ) on three bf16 parts an operand (``_mm3``); dK and dV summed
    over the group's heads in order and each head's query tiles of
    ``fp32_tile(d)`` in order, each tile's product in a fresh fp32
    accumulator added to the running sum; dQ over key tiles of
    ``fp32_tile(d)``, tile t into consumer t % 2's running sum (each tile
    fresh), then consumer 0's sum plus consumer 1's.  ``passes``: those
    of each product (``_mm3``)."""
    def mm(eq, a, b):
        return _mm3(eq, a, b, passes)

    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    tile = F32_TILE128 if d == 128 else F32_TILE
    qf = q.reshape(b, hkv, g, sq, d).float()
    dof = do.reshape(b, hkv, g, sq, d).float()
    kf, vf = k.float(), v.float()
    p = torch.exp(mm("bkgqd,bksd->bkgqs", qf, kf) * scale
                  - lse.reshape(b, hkv, g, sq, 1))
    if causal:
        p = torch.where(torch.arange(sq)[:, None] >= torch.arange(sk), p,
                        0.0)
    dsum = (dof * o.reshape(b, hkv, g, sq, d).float()).sum(-1, keepdim=True)
    ds = p * (mm("bkgqd,bksd->bkgqs", dof, vf) - dsum)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for head in range(g):
        for i0 in range(0, sq, tile):
            t = slice(i0, i0 + tile)
            dv += mm("bkqs,bkqd->bksd", p[:, :, head, t],
                       dof[:, :, head, t])
            dk += mm("bkqs,bkqd->bksd", ds[:, :, head, t],
                       qf[:, :, head, t])
    dq = [torch.zeros_like(qf), torch.zeros_like(qf)]
    for n, j0 in enumerate(range(0, sk, tile)):
        t = slice(j0, j0 + tile)
        dq[n % 2] += mm("bkgqs,bksd->bkgqd", ds[..., t], kf[:, :, t])
    return ((dq[0] + dq[1]).reshape(b, h, sq, d) * scale, dk * scale, dv)


def _fp32_case(shape, causal, seed):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(shape, seed=seed))
    lse = flash_attention_lse_plain(q, k, v, causal)
    o = flash_attention_plain(q, k, v, causal)
    args = (q, k, v, o, lse, do, causal)
    return args, flash_attention_bwd_plain(*args), \
        flash_attention_bwd_scale(*args)


def test_fp32_tiles_match_the_source():
    """The wrapper's name for the fp32 route's key tile (chip_smoke's
    planted fault drops it) is the source's constant at each head dim."""
    assert (fp32_tile(128), fp32_tile(64), fp32_tile(32)) == \
        (F32_TILE128, F32_TILE, F32_TILE)


@pytest.mark.parametrize("shape,causal",
                         HOLD_CASES + [(c, causal) for c in CASES
                                       for causal in (True, False)],
                         ids=str)
def test_fp32_kernel_arithmetic_within_atol(shape, causal):
    """The fp32 kernel's arithmetic (``_bwd_fp32_emulated``: three bf16
    parts an operand, six passes a product, its tiles and fresh
    accumulators) stays inside ATOL of each element's terms, far inside
    (3xTF32 leaves about 2^-21 of a term, these parts about 2^-24); the
    measure sees it (not 0)."""
    for seed in range(2):
        args, want, scale = _fp32_case(shape, causal, seed)
        got = _bwd_fp32_emulated(*args)
        assert all(g.dtype == torch.float32 for g in got)
        err = bwd_err(got, want, scale)
        assert 0.0 < err <= ATOL[torch.float32] / 10, (seed, err)


def test_one_bf16_part_misses_the_fp32_atol():
    """Why parts: the same arithmetic on one bf16 part an operand (one
    pass a product) misses ATOL[float32] by far."""
    shape, causal = HOLD_CASES[2]
    args, want, scale = _fp32_case(shape, causal, seed=0)
    err = bwd_err(_bwd_fp32_emulated(*args, passes=((0, 0),)), want, scale)
    assert err > 10 * ATOL[torch.float32], err


@pytest.mark.parametrize("dropped", ["tile", "item", 8])
@pytest.mark.parametrize("shape,causal", HOLD_CASES, ids=str)
def test_dropped_keys_fail_the_fp32_hold(shape, causal, dropped):
    """A backward that stops early by the fp32 route's last key tile of
    its dQ pass (``fp32_tile``), its last 64-key dK/dV item or the last 8
    keys fails the fp32 hold by far, also where those keys carry the
    smallest gradients (causal, sq = sk)."""
    args, want, scale = _fp32_case(shape, causal, seed=0)
    q, k, v, o, lse, do, _ = args
    n = {"tile": fp32_tile(q.shape[-1]), "item": F32_ITEM}.get(dropped,
                                                              dropped)
    sk = k.shape[2] - n
    dq, dk, dv = _bwd_fp32_emulated(q, k[:, :, :sk], v[:, :, :sk], o, lse,
                                    do, causal)
    pad = (0, 0, 0, n)
    err = bwd_err((dq, torch.nn.functional.pad(dk, pad),
                   torch.nn.functional.pad(dv, pad)), want, scale)
    assert err > 10 * ATOL[torch.float32], err


def test_bwd_err_measure():
    """``bwd_err``: 0 on equal gradients; inf on a wrong dtype or a NaN,
    and on a nonzero value where every term is zero."""
    args, want, scale = _bf16_case(HOLD_CASES[0][0], True, seed=0)
    assert bwd_err(want, want, scale) == 0.0
    assert bwd_err([w.float() for w in want], want, scale) == math.inf
    bad = [w.clone() for w in want]
    bad[0][0, 0, 0, 0] = float("nan")
    assert bwd_err(bad, want, scale) == math.inf
    zero = [torch.zeros_like(w) for w in want]
    assert bwd_err(zero, zero, [torch.zeros_like(s) for s in scale]) == 0.0
    assert bwd_err(want, zero, [torch.zeros_like(s) for s in scale]) == \
        math.inf


def test_backward_checks_its_inputs():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(CASES[0]))
    lse = flash_attention_lse_plain(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, q, lse[:, :, 1:], do)
    with pytest.raises(ValueError, match="must match"):
        flash_attention_bwd(q, k, v, q[:, :, 1:], lse, do)
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention_bwd(q, k[:, :1].expand(-1, 3, -1, -1),
                            v[:, :1].expand(-1, 3, -1, -1), q, lse, do)
