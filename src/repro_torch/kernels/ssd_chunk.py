"""``ssd_chunk``: the intra-chunk stage of the Mamba2 SSD cascade.

The CUDA kernel (``csrc/ssd_chunk.cu``) replaces the reference's Pallas
kernel ``_ssd_chunk_kernel``.  ``ssd_chunk`` launches it for tensors on
a CUDA device and takes the plain version, ``ssd_chunk_plain``, only for
tensors on the CPU.  Both compute the decay the way the kernel does, as
a difference of cumulative sums.  When grad mode is on and an input
requires a gradient, ``ssd_chunk`` goes through ``SsdChunk``: the
forward kernel, then the hand-written backward kernel
(``ssd_chunk_bwd.py``, ``csrc/ssd_chunk_bwd.cu``); on the CPU their plain
versions.  On the ``meta`` device it runs nothing: it returns an empty y
and reports ``flops`` and ``nbytes`` of the call (``kernels/meta.py``).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, meta

#: repro_ssd_chunk(x, a, b, c, y, B, nc, l, H, P, N, dtype, stream)
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
#: the kernel's dtype codes for x, b and c
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: G's rows of one 64-row tile sit in shared memory: 64 x 512 fp32 at most
MAX_CHUNK = 512


def _check(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor) -> None:
    if x.dim() != 5 or a.dim() != 4 or b.dim() != 4:
        raise ValueError(f"ssd_chunk: want x [B, nc, l, H, P], a [B, H, nc, "
                         f"l], b and c [B, nc, l, N]; got {tuple(x.shape)}, "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    B, nc, l, H, P = x.shape
    N = b.shape[-1]
    if tuple(a.shape) != (B, H, nc, l) or tuple(b.shape) != (B, nc, l, N) \
            or tuple(c.shape) != (B, nc, l, N):
        raise ValueError(f"ssd_chunk: shapes disagree: x {tuple(x.shape)}, "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"ssd_chunk: x, b and c must share float32 or "
                         f"bfloat16, got {x.dtype}, {b.dtype}, {c.dtype}")
    if a.dtype != torch.float32:
        raise ValueError(f"ssd_chunk: a must be float32, got {a.dtype}")
    for name, t in (("x", x), ("a", a), ("b", b), ("c", c)):
        if t.device != x.device:
            raise ValueError(f"ssd_chunk: x on {x.device}, {name} on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_chunk: {name} must be contiguous")


def flops(shape) -> int:
    """Operations of the causal half (j <= i) of G once per (b, c) and of
    Y per head, for a call of ``shape`` (B, nc, l, H, P, N)."""
    B, nc, l, H, P, N = shape
    tri = l * (l + 1) // 2
    return 2 * B * nc * tri * N + 2 * B * nc * H * tri * P


def nbytes(shape, dtype) -> int:
    """Bytes a call of ``shape`` must move: x, b and c (in ``dtype``) and
    a (fp32) read once, y (fp32) written once."""
    B, nc, l, H, P, N = shape
    es = torch.empty(0, dtype=dtype).element_size()
    return es * (B * nc * l * H * P + 2 * B * nc * l * N) \
        + 4 * B * H * nc * l + 4 * B * nc * l * H * P


def _meta(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The meta route: y empty, the call's operations and bytes
    reported (``kernels/meta.py``); a chunk above MAX_CHUNK raises, as a
    launch does."""
    B, nc, l, H, P = x.shape
    if l > MAX_CHUNK:
        raise ValueError(f"ssd_chunk: chunk length {l} > {MAX_CHUNK}")
    shape = (B, nc, l, H, P, b.shape[-1])
    meta.record("ssd_chunk", flops(shape), nbytes(shape, x.dtype))
    return torch.empty(x.shape, dtype=torch.float32, device=x.device)


def ssd_chunk_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    """Intra-chunk SSD outputs y_diag [B, nc, l, H, P] in float32, with
    the kernel's decay ``exp(cum[i] - cum[j])`` (``cum = cumsum(a)``),
    evaluated only on and below the diagonal.  ``cum`` is summed in
    float64 and rounded once, as the kernel sums it (and as PyTorch's CPU
    cumsum of float32 already does): two float32 scans in different
    orders differ by ulps of |cum|, which under strong decay (|cum| in the
    hundreds) move the decay by more than the kernel's tolerance."""
    cum = torch.cumsum(a.double(), dim=-1).float()           # [B,H,nc,l]
    diff = cum[..., :, None] - cum[..., None, :]             # [B,H,nc,l,l]
    l = a.shape[-1]
    mask = torch.ones(l, l, dtype=torch.bool, device=a.device).tril()
    decay = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    g = torch.einsum("bcln,bcsn->bcls", c.float(), b.float())  # [B,nc,l,s]
    w = decay * g[:, None]                                   # [B,H,nc,l,s]
    return torch.einsum("bhcls,bcshp->bclhp", w, x.float())


def _launch(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """One launch of the forward kernel on a CUDA device (counted on
    ``ssd_chunk.launches``)."""
    B, nc, l, H, P = x.shape
    N = b.shape[-1]
    if l > MAX_CHUNK:
        raise ValueError(f"ssd_chunk: chunk length {l} > {MAX_CHUNK}")
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    fn = build.function("ssd_chunk", "repro_ssd_chunk", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ssd_chunk.launches += 1
    build.check("ssd_chunk", fn(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                                c.data_ptr(), y.data_ptr(), B, nc, l, H, P,
                                N, _DTYPES[x.dtype], stream))
    return y


class SsdChunk(torch.autograd.Function):
    """``ssd_chunk`` with its gradient: the forward kernel (on the CPU
    ``ssd_chunk_plain``), then the backward kernel (on the CPU
    ``ssd_chunk_bwd_plain``) on a contiguous dy.  Saves x, a, b and c,
    not y."""

    @staticmethod
    def forward(ctx, x, a, b, c):
        if x.device.type == "cpu":
            y = ssd_chunk_plain(x, a, b, c)
        elif x.device.type == "meta":
            y = _meta(x, b)
        else:
            y = _launch(x, a, b, c)
        ctx.save_for_backward(x, a, b, c)
        return y

    @staticmethod
    def backward(ctx, dy):
        from .ssd_chunk_bwd import ssd_chunk_bwd
        x, a, b, c = ctx.saved_tensors
        return ssd_chunk_bwd(x, a, b, c, dy.contiguous())


def ssd_chunk(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor) -> torch.Tensor:
    """``ssd_chunk_plain``'s function; on a CUDA device, one launch of
    the hand-written kernel (counted on ``ssd_chunk.launches``); on the
    meta device, ``_meta``.  When grad mode is on and an input requires a
    gradient, through ``SsdChunk``, on the CPU too."""
    _check(x, a, b, c)
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"ssd_chunk: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, a, b, c)):
        return SsdChunk.apply(x, a, b, c)
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, a, b, c)
    if x.device.type == "meta":
        return _meta(x, b)
    return _launch(x, a, b, c)


ssd_chunk.launches = 0
