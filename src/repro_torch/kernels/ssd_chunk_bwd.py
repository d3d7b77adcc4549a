"""``ssd_chunk_bwd``: the gradient of ``ssd_chunk``.

The CUDA kernel (``csrc/ssd_chunk_bwd.cu``) replaces no TPU kernel: the
reference's Pallas kernel ``_ssd_chunk_kernel`` has no VJP, and the
reference trains through its plain jnp SSD.  The port's model path runs
the forward kernel on the card, so its training path needs this
gradient; ``ssd_chunk.SsdChunk`` calls it.

For each (b, c, h), with G = C B^T, L[i, j] = exp(cum[i] - cum[j]) on and
below the diagonal (cum = cumsum(a)) and W = G o L, the gradient of
y = W X given dy is: dx = W^T dy; dW = dy x^T on and below the diagonal;
dG = sum_h dW o L (over every head, since b and c are shared); dc = dG b,
db = dG^T c; M = dW o W, dcum = rowsum(M) - colsum(M), da = the reverse
cumsum of dcum.  dx, db and dc come back in their inputs' dtype, da in
fp32.

``ssd_chunk_bwd`` launches the kernel (wgmma products fed by TMA, no
atomics, so two calls give the same bits) for tensors on a CUDA device,
and takes the plain version, ``ssd_chunk_bwd_plain``, only for tensors
on the CPU.  The kernel is held to the plain version by ``bwd_err``:
each gradient element's error, less the one bf16 rounding both versions
make of a bf16 gradient, over the summed magnitude of its terms
(``ssd_chunk_bwd_scale``), within ``ATOL``.  On the ``meta`` device it
runs nothing: it returns empty gradients and reports ``flops`` and
``nbytes`` of the call (``kernels/meta.py``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from . import build, meta
from .ssd_chunk import _DTYPES, MAX_CHUNK, _check

#: repro_ssd_chunk_bwd(x, a, b, c, dy, dx, da, db, dc, scratch, B, nc, l,
#: H, N, hg, dtype, stream)
_ARGTYPES = (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 7 + \
    (ctypes.c_void_p,)
#: the kernel's launches in a call, in order (its entry functions' names)
LAUNCHES = ("cum_kernel", "g_kernel", "main_kernel", "dbdc_kernel",
            "da_kernel")
#: the kernel's head dim: one 64-column tile of X and dY a head (a
#: smaller one is padded with zeros)
MAX_HEAD_DIM = 64
#: the kernel's tiles of 64 rows i and 64 columns j: its scratch holds G
#: and dG's partials a tile, and per-tile shares of M's row sums
TILE = 64
#: the main pass's work items to aim for (``head_group``): about four a
#: streaming multiprocessor of an H100
ITEMS = 512
#: kernel vs plain version: ``bwd_err``'s measure, each gradient
#: element's error over the summed magnitude of its terms, after one
#: bf16 rounding of a bf16 gradient is taken out (``BF16_ROUNDING``).
#: What is left is fp32 arithmetic in both dtypes (dy, W and dG are fp32):
#: dX, G, dB and dC within about 2^-21 of a term (3xTF32, or 2xTF32 with
#: an operand exact in TF32); dW = dy x^T within about 2^-16 of a term (dy
#: as two bf16 parts, and in fp32 x too), whose errors average out over
#: dG's and M's sums; exp within 2 + floor(1.16 |e|) ulp (``__expf`` of e
#: <= 0, at most a few 1e-6 where L is not negligible); the tensor cores'
#: truncating accumulation, up to an ulp a step into a fresh accumulator
#: of at most 12 steps (1e-6); fp32 sums of a few hundred terms in another
#: order than the plain version's (about sqrt(n) 2^-24, 1e-6).  The CPU
#: emulation of the kernel's arithmetic (tests/test_torch_ssd_grad.py)
#: reads at most 2e-6; with dy rounded once to TF32 instead of split it
#: reads 3e-5 to 2.3e-4, and with one bf16 part of dy in dW 1.6e-4 to
#: 6.2e-4, over the limit.
ATOL = 1e-5
#: two roundings to bf16 (8 significant bits, round to nearest) of fp32
#: values that differ by d are at most d + 2^-8 (1 + 2^-7) (|u| + |v|)
#: apart: at most d + BF16_ROUNDING max(|u|, |v|)
BF16_ROUNDING = 2.0 ** -7 * (1 + 2.0 ** -7)
#: an element's scale is at least this share of its gradient's largest
#: scale, so that a product that underflows in one version and not the
#: other (a term of a few 1e-38) is no error
SCALE_FLOOR = 1e-6


def flops_by_product(shape) -> Tuple[int, int]:
    """Operations of the backward's products over the causal halves, for
    a call of ``shape`` (B, nc, l, H, P, N): (those once per (b, c): G =
    C B^T, dC = dG B, dB = dG^T C; those per head: dW = dY X^T,
    dX = W^T dY)."""
    B, nc, l, H, P, N = shape
    tri = l * (l + 1) // 2
    return 3 * 2 * B * nc * tri * N, 2 * 2 * B * nc * H * tri * P


def flops(shape) -> int:
    """All of ``flops_by_product``."""
    return sum(flops_by_product(shape))


def nbytes(shape, dtype) -> int:
    """Bytes a call of ``shape`` must move: x, b and c (in ``dtype``), a
    and dy (fp32) read once, dx, db and dc (in ``dtype``) and da (fp32)
    written once."""
    B, nc, l, H, P, N = shape
    es = torch.empty(0, dtype=dtype).element_size()
    xs, bcs, as_ = B * nc * l * H * P, B * nc * l * N, B * H * nc * l
    return es * (2 * xs + 4 * bcs) + 4 * xs + 2 * 4 * as_


def head_group(B: int, nc: int, l: int, H: int) -> int:
    """Heads a CTA of the kernel's main pass walks: the heads split into
    as few groups as give about ITEMS (cell, column tile, group) items,
    so that both train shapes fill the card; dG's head sum runs over each
    group's heads in order, then over the groups in order."""
    items = B * nc * -(-l // TILE)
    groups = min(H, max(1, -(-ITEMS // max(items, 1))))
    return -(-H // groups) if H else 1


def _check_bwd(x, a, b, c, dy) -> None:
    _check(x, a, b, c)
    if dy.shape != x.shape or dy.dtype != torch.float32:
        raise ValueError(f"ssd_chunk_bwd: dy must be float32 "
                         f"{tuple(x.shape)}, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    if dy.device != x.device:
        raise ValueError(f"ssd_chunk_bwd: x on {x.device}, dy on "
                         f"{dy.device}")
    if not dy.is_contiguous():
        raise ValueError("ssd_chunk_bwd: dy must be contiguous")


def _decay(a: torch.Tensor) -> torch.Tensor:
    """L [B, H, nc, l, l]: exp(cum[i] - cum[j]) on and below the
    diagonal, 0 above; cum summed in float64 and rounded once, as
    ``ssd_chunk_plain`` takes it."""
    cum = torch.cumsum(a.double(), dim=-1).float()
    diff = cum[..., :, None] - cum[..., None, :]
    l = a.shape[-1]
    mask = torch.ones(l, l, dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)


def _reverse_cumsum(v: torch.Tensor) -> torch.Tensor:
    """out[k] = v[k] + ... + v[l - 1], summed in float64 and rounded once
    (autograd's gradient of the float64 cumsum in ``ssd_chunk_plain``)."""
    return v.double().flip(-1).cumsum(-1).flip(-1).float()


def ssd_chunk_bwd_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, dy: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """(dx, da, db, dc) of ``ssd_chunk_plain`` given dy, written out in
    fp32 from the closed form (the module docstring), evaluated only on
    and below the diagonal: L is 0 above it, so W, dW o L and M are too.
    dx, db and dc in their inputs' dtype, da in fp32."""
    _check_bwd(x, a, b, c, dy)
    bf, cf = b.float(), c.float()
    L = _decay(a)                                             # [B,H,nc,l,s]
    w = L * torch.einsum("bcln,bcsn->bcls", cf, bf)[:, None]
    dx = torch.einsum("bhcls,bclhp->bcshp", w, dy)
    dw = torch.einsum("bclhp,bcshp->bhcls", dy, x.float())
    dg = (dw * L).sum(1)                                      # [B,nc,l,s]
    del L
    m = dw * w
    del dw, w
    dcum = m.sum(-1) - m.sum(-2)                              # [B,H,nc,l]
    del m
    dc = torch.einsum("bcls,bcsn->bcln", dg, bf)
    db = torch.einsum("bcls,bcln->bcsn", dg, cf)
    return (dx.to(x.dtype), _reverse_cumsum(dcum), db.to(b.dtype),
            dc.to(c.dtype))


def ssd_chunk_bwd_scale(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, dy: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """The summed magnitude of the terms of each element of (dx, da, db,
    dc), fp32, from ``ssd_chunk_bwd_plain``'s formulas with every factor
    taken by its magnitude: |G| <= |C| |B|^T, |W| <= |G| L, |dx| <=
    |W|^T |dy|, |dW| <= |dy| |x|^T (on and below the diagonal), |dG| <=
    sum_h |dW| L, |dc| <= |dG| |b|, |db| <= |dG|^T |c|, |M| <= |dW| |W|,
    and for da the reverse cumsum of rowsum(|M|) + colsum(|M|).  A
    rounding of each term by a relative u moves an element by at most u
    times its scale; ``bwd_err`` measures the error in these units."""
    bf, cf = b.float().abs(), c.float().abs()
    L = _decay(a)
    aw = L * torch.einsum("bcln,bcsn->bcls", cf, bf)[:, None]
    ady = dy.abs()
    sdx = torch.einsum("bhcls,bclhp->bcshp", aw, ady)
    adw = torch.einsum("bclhp,bcshp->bhcls", ady, x.float().abs())
    l = a.shape[-1]
    adw = torch.where(torch.ones(l, l, dtype=torch.bool,
                                 device=a.device).tril(), adw, 0.0)
    adg = (adw * L).sum(1)
    del L
    am = adw * aw
    del adw, aw
    sda = _reverse_cumsum(am.sum(-1) + am.sum(-2))
    del am
    return (sdx, sda, torch.einsum("bcls,bcln->bcsn", adg, cf),
            torch.einsum("bcls,bcsn->bcln", adg, bf))


def bwd_err(got, want, scale) -> float:
    """The largest error of (dx, da, db, dc) ``got`` against ``want``:
    each element's |got - want|, less BF16_ROUNDING max(|got|, |want|)
    where the gradient is bf16 (both versions round it once), over its
    ``scale`` (``ssd_chunk_bwd_scale``; at least SCALE_FLOOR of its
    gradient's largest): ``ATOL``'s measure.  inf on a wrong shape or
    dtype or a non-finite value."""
    worst = 0.0
    for g, w, s in zip(got, want, scale):
        if g.shape != w.shape or g.dtype != w.dtype or \
                not bool(torch.isfinite(g).all()):
            return math.inf
        if g.numel() == 0:
            continue
        gf, wf = g.float(), w.float()
        diff = (gf - wf).abs()
        if g.dtype == torch.bfloat16:
            diff = (diff - BF16_ROUNDING * torch.maximum(gf.abs(), wf.abs())
                    ).clamp_min(0.0)
        floor = SCALE_FLOOR * float(s.max())
        if floor == 0.0:
            if bool((diff != 0).any()):
                return math.inf
            continue
        worst = max(worst, float((diff / s.clamp_min(floor)).max()))
    return worst


def _launch(x, a, b, c, dy, ms=None):
    """One call of the kernel's five launches on x's CUDA device (counted
    once); ``ms``: None, or a ctypes array of five floats that the timed
    entry fills with each launch's device ms (``LAUNCHES``' order)."""
    B, nc, l, H, P = x.shape
    N = b.shape[-1]
    if l > MAX_CHUNK:
        raise ValueError(f"ssd_chunk_bwd: chunk length {l} > {MAX_CHUNK}")
    if P > MAX_HEAD_DIM:
        raise ValueError(f"ssd_chunk_bwd: head dim {P} > {MAX_HEAD_DIM}")
    if H * P == 0:
        x, dy = x.new_zeros(B, nc, l, H, MAX_HEAD_DIM), \
            dy.new_zeros(B, nc, l, H, MAX_HEAD_DIM)
    elif P < MAX_HEAD_DIM:                 # the kernel's tiles: zeros past P
        pad = (0, MAX_HEAD_DIM - P)
        x, dy = torch.nn.functional.pad(x, pad), \
            torch.nn.functional.pad(dy, pad)
    # TMA reads x and dy from 16-byte addresses
    x, dy = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, dy))
    dx = torch.empty_like(x)
    da = torch.empty_like(a)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    if B * nc * l == 0:
        return dx[..., :P], da, db, dc
    hg = head_group(B, nc, l, H)
    n_rt = -(-l // TILE)
    tiles = n_rt * (n_rt + 1) // 2
    scratch = torch.empty(
        B * H * nc * n_rt * TILE + (1 + -(-H // hg)) * B * nc * tiles
        * TILE * TILE + n_rt * 2 * B * H * nc * l,
        dtype=torch.float32, device=x.device)
    args = [x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), da.data_ptr(), db.data_ptr(),
            dc.data_ptr(), scratch.data_ptr(), B, nc, l, H, N, hg,
            _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream]
    if ms is None:
        fn = build.function("ssd_chunk_bwd", "repro_ssd_chunk_bwd", _ARGTYPES)
    else:
        fn = build.function("ssd_chunk_bwd", "repro_ssd_chunk_bwd_timed",
                            _ARGTYPES + (ctypes.c_void_p,))
        args.append(ctypes.addressof(ms))
    _COUNTER.launches += 1
    build.check("ssd_chunk_bwd", fn(*args))
    return (dx if P == MAX_HEAD_DIM else dx[..., :P].contiguous()), da, db, dc


def ssd_chunk_bwd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, dy: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """``ssd_chunk_bwd_plain``'s function; on a CUDA device, one call of
    the hand-written kernel's five launches (counted once, on
    ``ssd_chunk_bwd.launches``); on the meta device, empty gradients and
    the call's count.  Outside the kernel's domain (chunk above
    MAX_CHUNK, head dim above MAX_HEAD_DIM, devices) it raises."""
    _check_bwd(x, a, b, c, dy)
    if x.device.type == "cpu":
        return ssd_chunk_bwd_plain(x, a, b, c, dy)
    if x.device.type == "meta":
        B, nc, l, H, P = x.shape
        if l > MAX_CHUNK or P > MAX_HEAD_DIM:
            raise ValueError(f"ssd_chunk_bwd: chunk length {l} (at most "
                             f"{MAX_CHUNK}), head dim {P} (at most "
                             f"{MAX_HEAD_DIM})")
        shape = (B, nc, l, H, P, b.shape[-1])
        meta.record("ssd_chunk_bwd", flops(shape), nbytes(shape, x.dtype))
        return tuple(torch.empty_like(t) for t in (x, a, b, c))
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_bwd: no kernel for device {x.device}")
    return _launch(x, a, b, c, dy)


def ssd_chunk_bwd_launch_ms(x: torch.Tensor, a: torch.Tensor,
                            b: torch.Tensor, c: torch.Tensor,
                            dy: torch.Tensor) -> Dict[str, float]:
    """The device ms of each of the kernel's launches (``LAUNCHES``) in
    one call on these inputs, from CUDA events recorded around each on
    the stream (the call counts as a launch).  For measurement; CUDA
    tensors only."""
    _check_bwd(x, a, b, c, dy)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_bwd_launch_ms: no kernel for device "
                         f"{x.device}")
    ms = (ctypes.c_float * len(LAUNCHES))()
    _launch(x, a, b, c, dy, ms)
    return dict(zip(LAUNCHES, map(float, ms)))


ssd_chunk_bwd.launches = 0
#: the function whose ``launches`` count the kernel's launches, whatever
#: the module's name is bound to later (a recording or a planted fault)
_COUNTER = ssd_chunk_bwd
