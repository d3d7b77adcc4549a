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
    ATOL, bwd_err, flash_attention_bwd_scale)

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
