"""``flash_attention_bwd``: the gradient of ``flash_attention``.

The CUDA kernel (``csrc/flash_attention_bwd.cu``) replaces no TPU
kernel: the reference's Pallas kernel ``_attn_kernel`` has no VJP, and
the reference trains through plain jnp attention.  The port's model path
runs the forward kernel on the card, so its training path needs this
gradient; ``flash_attention.FlashAttention`` calls it.

``flash_attention_bwd`` launches the kernel (FlashAttention-2's method:
``D = rowsum(do o)``, then one pass parallel over key blocks for dK and
dV, one over query blocks for dQ; wgmma fed by TMA in both dtypes, in
fp32 with each operand as three bf16 parts, written once by a pass of
their own, and each product as six bf16 passes; no atomics, so the
gradient is the same bits on every run) for tensors on a CUDA device,
and takes the plain version,
``flash_attention_bwd_plain``, only for tensors on the CPU.
Both recompute the softmax weights from the forward's log-sum-exp
(``flash_attention_lse_plain``'s function).  The kernel is held to the
plain version by ``bwd_err``: each gradient element's error over the
summed magnitude of its terms (``flash_attention_bwd_scale``), within
``ATOL``.  On the ``meta`` device it runs nothing: it returns empty
gradients and reports ``flops`` and ``nbytes`` of the call
(``kernels/meta.py``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch.sharding.logical import is_sharded

from . import build, meta
from .flash_attention import (_DTYPES, HEAD_DIMS, Split, _check,
                              _kernel_layout)
from .flash_attention import flops as _forward_flops

#: repro_flash_attention_bwd(q, k, v, o, lse, do, dq, dk, dv, dsum, B, H,
#: Hkv, sq, sk, d, causal, scale, dtype, strides, stream)
_ARGTYPES = (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 7 + \
    (ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
#: kernel vs plain version, by dtype: ``bwd_err``'s measure, each
#: gradient element's error over the summed magnitude of its terms
#: (``flash_attention_bwd_scale``), so that a key seen by one query counts
#: as much as one seen by all.  bf16: the inputs are the same bf16 values;
#: the kernel rounds P (for dV) and dS (for dK and dQ) to bf16, at most
#: u = 2^-8 of each term, and both versions round each gradient once to
#: bf16; two roundings of values less than one ulp apart differ by at most
#: one ulp (2^-7 of the value), so an element is off by at most 2^-7 + 2^-8
#: = 1.17e-2 of its terms' magnitude.  fp32: each operand as three bf16
#: parts (x to 2^-27 of itself) and each product as the six passes whose
#: order stays above 2^-24 (about 2^-24 of a term), P from ``ex2.approx``
#: (2^-22), fp32 sums of up to a few thousand terms in another order than
#: the plain version's, each tile's product in a fresh accumulator: a few
#: 1e-6 of the terms' magnitude.
ATOL = {torch.float32: 5e-5, torch.bfloat16: 1.5e-2}
#: the kernel's launches in one call, in order, by dtype: pass 1 (D),
#: in fp32 pass 1b (the operands' bf16 parts) before it, then dK/dV and dQ
LAUNCHES = {torch.bfloat16: ("dsum_kernel", "dkdv_kernel", "dq_kernel"),
            torch.float32: ("split3_kernel", "dsum_kernel", "dkdv_kernel",
                            "dq_kernel")}
#: the kernel's scratch holds pass 1's rows (lse in log2 units and D) for
#: sq rounded up to a multiple of this (the bf16 route's query block)
ROW_PAD = 128
#: an element's scale is at least this share of its gradient's largest
#: scale, so that a product that underflows in one version and not the
#: other (a term of a few 1e-38) is no error
SCALE_FLOOR = 1e-6


def fp32_tile(d: int) -> int:
    """Rows of the fp32 route's streamed tiles at head dim ``d``: query
    tiles of the dK/dV pass, key tiles of the dQ pass (``kTileF128`` at
    d 128, ``kTileF`` below)."""
    return 32 if d == 128 else 64


def scratch_parts(shape, dtype) -> int:
    """fp32 values of the scratch that the fp32 route's bf16 parts of q,
    do, k and v take (three bf16 values an element, two to an fp32
    value); none in bf16."""
    if dtype != torch.float32:
        return 0
    b, h, hkv, sq, sk, d = shape
    return 3 * (b * h * sq + b * hkv * sk) * d


def flops(shape, causal: bool = True) -> int:
    """Operations of the backward's five products (S, dP, dV, dK, dQ; the
    forward has two) over the pairs the mask keeps, for a call of
    ``shape`` (b, h, hkv, sq, sk, d)."""
    return _forward_flops(shape, causal) * 5 // 2


def nbytes(shape, dtype) -> int:
    """Bytes a call of ``shape`` must move: q, k, v, o and do read once
    and dq, dk and dv written once in ``dtype``, the fp32 lse read
    once."""
    b, h, hkv, sq, sk, d = shape
    es = torch.empty(0, dtype=dtype).element_size()
    return es * (4 * b * h * sq * d + 4 * b * hkv * sk * d) + 4 * b * h * sq


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dq, dk, dv) of softmax attention from the forward's output ``o``
    and row log-sum-exp ``lse`` [b, h, sq], written out in fp32 from
    FlashAttention-2's formulas: P = exp(s - lse) under the mask,
    D = rowsum(do o), dV = P^T dO, dS = P (dO V^T - D), dQ = scale dS K,
    dK = scale dS^T Q, dK and dV summed over each KV head's group; each
    gradient in its input's dtype."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.reshape(b, hkv, g, sq, d).float()
    dof = do.reshape(b, hkv, g, sq, d).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    p = torch.exp(s - lse.reshape(b, hkv, g, sq, 1).float())
    del s
    if causal:
        mask = torch.arange(sq, device=q.device)[:, None] >= \
            torch.arange(sk, device=q.device)[None, :]
        p = torch.where(mask, p, 0.0)
    dsum = (dof * o.reshape(b, hkv, g, sq, d).float()).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dof, vf) - dsum)
    del p
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd_scale(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The summed magnitude of the terms of each element of (dq, dk, dv),
    fp32, from ``flash_attention_bwd_plain``'s formulas with every factor
    taken by its magnitude: |dV| <= P^T |dO|, |dS| <= P (|dO| |V|^T +
    rowsum(|dO| |O|)), |dK| <= scale |dS|^T |Q|, |dQ| <= scale |dS| |K|.
    A rounding of each term by a relative u moves an element by at most
    u times its scale; ``bwd_err`` measures the error in these units."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.reshape(b, hkv, g, sq, d).float()
    dof = do.reshape(b, hkv, g, sq, d).float().abs()
    kf, vf = k.float(), v.float()
    p = torch.exp(torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale -
                  lse.reshape(b, hkv, g, sq, 1).float())
    if causal:
        mask = torch.arange(sq, device=q.device)[:, None] >= \
            torch.arange(sk, device=q.device)[None, :]
        p = torch.where(mask, p, 0.0)
    dsum = (dof * o.reshape(b, hkv, g, sq, d).float().abs()).sum(
        -1, keepdim=True)
    sv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dof, vf.abs()) + dsum)
    del p
    sq_ = torch.einsum("bkgqs,bksd->bkgqd", ds, kf.abs()) * scale
    sk_ = torch.einsum("bkgqs,bkgqd->bksd", ds, qf.abs()) * scale
    return sq_.reshape(b, h, sq, d), sk_, sv


def bwd_err(got, want, scale) -> float:
    """The largest error of (dq, dk, dv) ``got`` against ``want``, each
    element's over its ``scale`` (``flash_attention_bwd_scale``; at least
    SCALE_FLOOR of its gradient's largest): ``ATOL``'s measure.  inf on a
    wrong shape or dtype or a non-finite value."""
    worst = 0.0
    for g, w, s in zip(got, want, scale):
        if g.shape != w.shape or g.dtype != w.dtype or \
                not bool(torch.isfinite(g).all()):
            return math.inf
        if g.numel() == 0:
            continue
        floor = SCALE_FLOOR * float(s.max())
        if floor == 0.0:
            if bool((g != w).any()):
                return math.inf
            continue
        worst = max(worst, float(((g.float() - w.float()).abs() /
                                  s.clamp_min(floor)).max()))
    return worst


def _meta(q, k, v, causal: bool, split=None):
    """One device's meta call: empty gradients and the call's count, on
    its shards split by ``split`` (``flash_attention.Split``; None: the
    whole call)."""
    b, h, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {d} not in "
                         f"{HEAD_DIMS}")
    shape = (b, h, k.shape[1], sq, k.shape[2], d)
    if split is not None:
        shape = split.local_shape(shape)
    meta.record("flash_attention_bwd",
                split.busiest(flops, shape, causal) if split else
                flops(shape, causal), nbytes(shape, q.dtype))
    return tuple(torch.empty_like(t) for t in (q, k, v))


def _meta_sharded(q, k, v, o, lse, do, causal: bool):
    """The meta route on DTensors: each rank's shards, laid out as the
    forward's (``flash_attention.Split``), through ``_meta``."""
    split = Split(q, k)

    def body(ql, kl, vl, _o, _lse, _do):
        return _meta(ql, kl, vl, causal, split)
    return meta.local(body, (q, k, v, o, lse, do),
                      (split.q, split.kv, split.kv, split.q, split.q,
                       split.q), (split.q, split.dkv, split.dkv))


def _check_bwd(q, k, v, o, lse, do) -> None:
    """Raises outside the forward's domain (dtype, GQA grouping, shapes,
    devices)."""
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} "
                         f"{o.dtype} and do {tuple(do.shape)} {do.dtype} "
                         f"must match q {tuple(q.shape)} {q.dtype}")
    b, h, sq, d = q.shape
    if tuple(lse.shape) != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be float32 "
                         f"{(b, h, sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    for name, t in (("o", o), ("lse", lse), ("do", do)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_bwd: q on {q.device}, {name} "
                             f"on {t.device}")


def _launch(q, k, v, o, lse, do, causal: bool, ms=None):
    """One call of the kernel's launches on q's CUDA device (counted
    once); ``ms``: None, or a ctypes array of four floats that the timed
    entry fills with each launch's device ms (``LAUNCHES``' order)."""
    b, h, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {d} not in "
                         f"{HEAD_DIMS}")
    hkv, sk = k.shape[1], k.shape[2]
    q, k, v, o, do = (_kernel_layout(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0 and dk.numel() == 0:
        return dq, dk, dv
    # pass 1's rows, padded to 128 a (b, h): lse in log2 units, then D;
    # in fp32 then q, do, k and v as three bf16 parts each
    sq_pad = -(-sq // ROW_PAD) * ROW_PAD
    dsum = torch.empty(2 * b * h * sq_pad + scratch_parts(
        (b, h, hkv, sq, sk, d), q.dtype), dtype=torch.float32,
        device=q.device)
    strides = (ctypes.c_int64 * 24)(*(s for t in (q, k, v, o, do, dq, dk, dv)
                                      for s in t.stride()[:3]))
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dsum.data_ptr(), b, h, hkv, sq, sk, d,
            int(causal), 1.0 / math.sqrt(d), _DTYPES[q.dtype],
            ctypes.addressof(strides),
            torch.cuda.current_stream(q.device).cuda_stream]
    if ms is None:
        fn = build.function("flash_attention_bwd",
                            "repro_flash_attention_bwd", _ARGTYPES)
    else:
        fn = build.function("flash_attention_bwd",
                            "repro_flash_attention_bwd_timed",
                            _ARGTYPES + (ctypes.c_void_p,))
        args.append(ctypes.addressof(ms))
    _COUNTER.launches += 1
    build.check("flash_attention_bwd", fn(*args))
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """``flash_attention_bwd_plain``'s function; on a CUDA device, one
    call of the hand-written kernel's launches (``LAUNCHES``; counted
    once, on ``flash_attention_bwd.launches``); on the meta device,
    empty gradients and the call's count.  The gradients have their
    inputs' layouts.  Outside the forward's domain (dtype, head dim, GQA
    grouping, devices) it raises."""
    _check_bwd(q, k, v, o, lse, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    if q.device.type == "meta":
        if is_sharded(q):
            return _meta_sharded(q, k, v, o, lse, do, causal)
        return _meta(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device "
                         f"{q.device}")
    return _launch(q, k, v, o, lse, do, causal)


def flash_attention_bwd_launch_ms(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor,
                                  causal: bool = True) -> Dict[str, float]:
    """The device ms of each of the kernel's launches (``LAUNCHES``) in
    one call on these inputs, from CUDA events recorded around each on
    the stream (the call counts as a launch).  For measurement; CUDA
    tensors only."""
    _check_bwd(q, k, v, o, lse, do)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_launch_ms: no kernel for "
                         f"device {q.device}")
    ms = (ctypes.c_float * 4)()
    _launch(q, k, v, o, lse, do, causal, ms)
    return dict(zip(LAUNCHES[q.dtype], map(float, ms)))


flash_attention_bwd.launches = 0
#: the function whose ``launches`` count the kernel's launches, whatever
#: the module's name is bound to later (a recording or a planted fault)
_COUNTER = flash_attention_bwd
