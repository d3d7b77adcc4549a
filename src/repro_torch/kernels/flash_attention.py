"""``flash_attention``: softmax attention with GQA in one pass over the
keys.

The CUDA kernels (``csrc/flash_attention.cu``) replace the reference's
Pallas kernel ``_attn_kernel``.  ``flash_attention`` launches one for
tensors on a CUDA device and takes the plain version,
``flash_attention_plain`` (the oracle ``ref.attention_ref``), only for
tensors on the CPU.  The causal mask is top-left aligned (query i sees
keys j <= i, also when sq != sk); the result has ``q``'s dtype.

In bf16 the kernel runs both products on the tensor cores (wgmma, with
TMA loading the tiles): fp32 scores, an fp32 carry, and the softmax
weights rounded to bf16 for the PV product, as the reference model's
attention rounds them.  In fp32 it runs both products on the TF32 tensor
cores as 3xTF32 (``wgmma``; each operand split into a TF32 high and
low part, about 2^-21 of a product), with the scores, the carry and the
softmax weights kept in fp32: within 2e-5 of the plain version.

Under autograd (an input that requires a gradient, grad mode on) the
call is ``FlashAttention``, a ``torch.autograd.Function``: its forward
launches the kernel with each row's log-sum-exp as a second output
(``flash_attention_lse_plain``'s function), saves q, k, v, o and it, and
its backward launches the hand-written backward kernel
(``flash_attention_bwd``).  Without autograd nothing more is written.
On the CPU, ``flash_attention`` is the plain version, and under autograd
``FlashAttention`` on the plain versions of both kernels, so the CPU
tests take the card's gradient path with the plain versions in it.  On
the ``meta`` device (a dry run, ``kernels/meta.py``) it runs nothing: it
returns empty outputs and reports ``flops`` and ``nbytes`` of the call.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build, meta
from .ref import attention_ref

#: repro_flash_attention(q, k, v, o, lse, B, H, Hkv, sq, sk, d, causal,
#: scale, dtype, strides, stream)
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7 + \
    (ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
#: the kernel's dtype codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is built for: the smoke configs, the bench, the
#: full configs
HEAD_DIMS = (32, 64, 128)
#: kernel vs plain version, max abs error by dtype: in fp32 both take fp32
#: scores, softmax and products from the same inputs (3xTF32 keeps about
#: 2^-21 of a product), so they differ by summation order only (the
#: reference test's 2e-6, with headroom for another order).  In bf16 the
#: kernel rounds the softmax weights to bf16 for the tensor-core PV product
#: (at most about 2^-9 of |v| per weight, as the reference model's
#: attention rounds them) and then the output once; the plain version
#: keeps PV in fp32: the reference test's 2e-2.
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: want q [b, h, sq, d] and k, v "
                         f"[b, hkv, sk, d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] == 0 or \
            h % k.shape[1]:
        raise ValueError(f"flash_attention: shapes disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)} (the kv "
                         f"heads must divide the query heads)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k and v must share float32 "
                         f"or bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: q on {q.device}, {name} on "
                             f"{t.device}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Softmax attention over q [b, h, sq, d], k, v [b, hkv, sk, d] in
    float32, returned in ``q``'s dtype (``ref.attention_ref``)."""
    return attention_ref(q, k, v, causal)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True
                              ) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled scores, ln sum_j exp(q_i .
    k_j / sqrt(d)) over the keys it sees, fp32 [b, h, sq] (-inf for a
    row with none): what the forward kernel writes for the backward."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qr = q.reshape(b, hkv, h // hkv, sq, d).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qr, k.float()) / math.sqrt(d)
    if causal:
        mask = torch.arange(sq, device=q.device)[:, None] >= \
            torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(~mask, -math.inf)
    return torch.logsumexp(s, dim=-1).reshape(b, h, sq)


def flops(shape, causal: bool = True) -> int:
    """Operations of QK^T and PV over the (query, key) pairs the mask
    keeps, for a call of ``shape`` (b, h, hkv, sq, sk, d)."""
    b, h, hkv, sq, sk, d = shape
    if causal:      # query i keeps keys 0..min(i, sk - 1)
        n = min(sq, sk)
        pairs = n * (n + 1) // 2 + max(sq - sk, 0) * sk
    else:
        pairs = sq * sk
    return 4 * b * h * d * pairs


def nbytes(shape, dtype, with_lse: bool = False) -> int:
    """Bytes a call of ``shape`` must move: q, k and v read once and o
    written once in ``dtype`` (and, ``with_lse``, the rows' fp32
    log-sum-exp written once)."""
    b, h, hkv, sq, sk, d = shape
    es = torch.empty(0, dtype=dtype).element_size()
    return es * (2 * b * h * sq * d + 2 * b * hkv * sk * d) + \
        (4 * b * h * sq if with_lse else 0)


def _meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
          with_lse: bool):
    """The meta route: (o, lse or None) empty, the call's operations and
    bytes reported (``kernels/meta.py``); outside the kernel's head dims
    it raises, as a launch does."""
    b, h, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    shape = (b, h, k.shape[1], sq, k.shape[2], d)
    meta.record("flash_attention", flops(shape, causal),
                nbytes(shape, q.dtype, with_lse))
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    return torch.empty_like(q), lse


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is when the kernel can read it in place (the last
    dimension contiguous; base and strides on 16 bytes, as TMA needs in
    bf16 and float4 loads in fp32), else a fresh contiguous copy."""
    per_16 = 16 // t.element_size()
    if t.stride(-1) == 1 and all(s % per_16 == 0 for s in t.stride()[:3]) \
            and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, with_lse: bool):
    """One launch of the kernel on checked CUDA tensors (counted on
    ``flash_attention.launches``): (o, lse or None, and q, k, v as the
    kernel read them)."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    q, k, v = (_kernel_layout(t) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if o.numel() == 0:
        return o, lse, (q, k, v)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, o)
                                      for s in t.stride()[:3]))
    fn = build.function("flash_attention", "repro_flash_attention",
                        _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    flash_attention.launches += 1
    build.check("flash_attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, hkv, sq, sk, d,
        int(causal), 1.0 / math.sqrt(d), _DTYPES[q.dtype],
        ctypes.addressof(strides), stream))
    return o, lse, (q, k, v)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward kernel with
    the rows' log-sum-exp (on the CPU the plain versions of both), the
    backward kernel (on the CPU ``flash_attention_bwd_plain``).  Saves
    q, k, v, o and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cpu":
            o = flash_attention_plain(q, k, v, causal)
            lse = flash_attention_lse_plain(q, k, v, causal)
        elif q.device.type == "meta":
            o, lse = _meta(q, k, v, causal, with_lse=True)
        else:
            o, lse, (q, k, v) = _launch(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        from .flash_attention_bwd import flash_attention_bwd
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """``flash_attention_plain``'s function; on a CUDA device, one
    launch of the hand-written kernel (counted on
    ``flash_attention.launches``); on the meta device, ``_meta``.  When an
    input requires a gradient, through ``FlashAttention``, on the CPU
    too.  The output has ``q``'s layout, so a [b, h, s, d] view of a
    [b, s, h, d] tensor comes back as one."""
    _check(q, k, v)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type == "meta":
        return _meta(q, k, v, causal, with_lse=False)[0]
    return _launch(q, k, v, causal, with_lse=False)[0]


flash_attention.launches = 0
