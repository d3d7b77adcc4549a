"""Mamba2 SSD (state-space duality) layers  [arXiv:2405.21060]: the
PyTorch port of the reference's ``models/ssm.py``.

The chunked SSD algorithm is a cascade over a partitioned S rank:

    (1) intra-chunk:  Y_diag[c, l] = C[c, l] . L[c, l, l'] . B[c, l'] X[c, l']
    (2) chunk states: S[c]        = sum_l decay(l) B[c, l] X[c, l]
    (3) inter-chunk:  S'[c]       = scan over c (the carried recurrence)
    (4) state out:    Y_off[c, l] = C[c, l] . decay . S'[c-1]

Stage (1) is the quadratic block and runs on the hand-written kernel
``kernels.ssd_chunk`` (its plain version for tensors on the CPU), and
under autograd on its backward kernel too (``kernels.SsdChunk``); stages
(2-4) are plain PyTorch, the reference's ``lax.scan`` a loop over chunks.

Parameters sit in ``Params`` modules (``MambaLayer``, ``MambaBlock``,
``Mamba2LM``) under the reference's names; the functions keep the
reference's signatures with a module where it passes a pytree.  dtype
casts follow the reference's one for one: torch refuses mixed-dtype
products where JAX promotes, so an operand in the model dtype meeting
an fp32 one is cast to fp32 first, which is what JAX's promotion and
``preferred_element_type=float32`` compute.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import meta
from repro_torch.kernels.ssd_chunk import ssd_chunk
from repro_torch.models import layers as L
from repro_torch.models.layers import Params
from repro_torch.sharding.logical import (constrain, is_sharded,
                                          placements_of, reshard)


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    """(d_inner, n_heads, head_dim, d_state, conv_dim)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.d_state          # x, B, C all pass the conv
    return d_in, nh, s.head_dim, s.d_state, conv_dim


# ---------------------------------------------------------------------- #
# parameters
# ---------------------------------------------------------------------- #
class MambaLayer(Params):
    """One Mamba2 mixer: ``w_in``, ``conv_w`` [K, C], ``conv_b``,
    ``A_log``, ``D``, ``dt_bias``, ``norm``, ``w_out``."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        d = cfg.d_model
        d_in, nh, p, n, conv_dim = dims(cfg)
        dt = L._dtype(cfg)
        proj_out = 2 * d_in + 2 * n + nh          # z, xBC, dt
        k = cfg.ssm.d_conv

        def normal(shape, fan):
            return L._normal(shape, gen, device, 1.0 / math.sqrt(fan), dt)

        self.add("w_in", normal((d, proj_out), d))
        self.add("conv_w", normal((k, conv_dim), k))
        self.add("conv_b", torch.zeros(conv_dim, dtype=dt, device=device))
        self.add("A_log", torch.log(torch.linspace(
            1.0, 16.0, nh, device=device)).float())
        self.add("D", torch.ones(nh, dtype=torch.float32, device=device))
        self.add("dt_bias", torch.log(torch.expm1(torch.full(
            (nh,), 1e-2, dtype=torch.float32, device=device))))
        self.add("norm", torch.ones(d_in, dtype=torch.float32,
                                    device=device))
        self.add("w_out", normal((d_in, d), d_in))


class MambaBlock(Params):
    """Pre-norm residual block: ``ln`` then ``mamba``."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.ln = L.init_rmsnorm(cfg, device=device)
        self.mamba = MambaLayer(cfg, gen, device)


class Mamba2LM(Params):
    """The language model: ``embed``, ``blocks`` (one per layer; the
    reference's scanned stack is a list here) and ``ln_f``."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.embed = L.init_embedding(cfg, gen, device)
        self.blocks = nn.ModuleList(MambaBlock(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.init_rmsnorm(cfg, device=device)


# ---------------------------------------------------------------------- #
# the SSD cascade (prefill)
# ---------------------------------------------------------------------- #
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: out[..., i, j] = sum_{j<k<=i} x[k];
    -inf above the diagonal (so exp() gives the causal decay mask)."""
    l = x.shape[-1]
    xx = x[..., None].expand(*x.shape, l)                    # [..., l, l]
    mask = torch.ones(l, l, dtype=torch.bool, device=x.device)
    xx = torch.where(mask.tril(-1), xx, 0.0)
    out = torch.cumsum(xx, dim=-2)
    return torch.where(mask.tril(0), out, -math.inf)


def _heads(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with its batch (dim 0) and its heads (``dim``) split as the
    reference's constraint on the SSD's input splits them, its gradient
    too: as XLA propagates that constraint through the SSD's stages
    (2-4), which DTensor would otherwise lay out its own way, down to a
    strided shard of the einsums' folded batch (minutes of planning)."""
    axes = [None] * t.dim()
    axes[0], axes[dim] = "batch", "heads"
    return constrain(t, tuple(axes))


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        chunk: int, init_state: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked state-space dual form.

    x: [B, S, H, P] (pre-multiplied by dt); a: [B, S, H] (= A*dt, <=0);
    b, c: [B, S, N] (single group, broadcast over heads).
    Returns (y [B, S, H, P], final_state [B, H, P, N]), both float32.
    S must be a multiple of ``chunk``.
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    nc = S // chunk
    xc = x.reshape(B, nc, chunk, H, P)
    ac = a.reshape(B, nc, chunk, H).permute(0, 3, 1, 2)      # [B,H,nc,l]
    bc = b.reshape(B, nc, chunk, N)
    cc = c.reshape(B, nc, chunk, N)

    a_cum = torch.cumsum(ac, dim=-1)                          # [B,H,nc,l]

    # (1) intra-chunk (diagonal blocks): the hand-written kernel
    y_diag = ssd_chunk(xc.contiguous(), ac.contiguous(), bc.contiguous(),
                       cc.contiguous())

    # (2) per-chunk end states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)         # [B,H,nc,l]
    xw = _heads(xc.float() * decay_states.permute(0, 2, 3, 1)[..., None],
                3)
    states = _heads(torch.einsum("bcln,bclhp->bchpn", bc.float(), xw), 2)

    # (3) inter-chunk recurrence (the carried scan over chunks)
    carry = (torch.zeros((B, H, P, N), dtype=states.dtype, device=x.device)
             if init_state is None else init_state)
    chunk_decay = torch.exp(a_cum[..., -1])                   # [B,H,nc]
    prev = []
    for i in range(nc):
        prev.append(carry)                    # the state *before* chunk i
        carry = carry * chunk_decay[:, :, i, None, None] + states[:, i]
    prev_states = _heads(torch.stack(prev, dim=1), 2)         # [B,nc,H,P,N]

    # (4) state->output conversion
    state_decay = torch.exp(a_cum)                            # [B,H,nc,l]
    y_off = _heads(torch.einsum("bcln,bchpn->bclhp", cc.float(),
                                prev_states), 3) \
        * state_decay.permute(0, 2, 3, 1)[..., None]

    y = (y_diag + y_off).reshape(B, S, H, P)
    return y, carry


def _conv1d(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
            state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal depthwise conv over time. xbc: [B, S, C]; w: [K, C] (the
    reference's layout; torch's depthwise weight is [C, 1, K], and both
    are cross-correlations).  On DTensors (a walked mesh), each rank's
    channels through this function (``_conv1d_sharded``)."""
    if is_sharded(xbc):
        return _conv1d_sharded(xbc, w, bias, state)
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], K - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1).transpose(1, 2)         # [B, C, S+K-1]
    weight = w.to(xbc.dtype).t().contiguous()[:, None, :]     # [C, 1, K]
    out = F.conv1d(xp, weight, groups=xbc.shape[2]).transpose(1, 2)
    return F.silu(out + bias)


def _conv1d_sharded(xbc, w, bias, state):
    """``_conv1d`` over a walked mesh: the channels over ``model`` where
    they divide it (a depthwise conv keeps each channel apart, so no
    collective; DTensor has no rule for a grouped convolution), the
    batch over ``pod`` and ``data`` (``logical.placements_of``; the
    channels take the rule of a width split over ``model``, ``ff``)."""
    x_p = placements_of(xbc.shape, ("batch", None, "ff"))
    w_p = placements_of(w.shape, (None, "ff"))
    b_p = placements_of(bias.shape, ("ff",))
    args, places = (xbc, w, bias), (x_p, w_p, b_p)
    if state is not None:
        args, places = args + (state,), places + (x_p,)
    return meta.local(lambda *ts: _conv1d(*ts), args, places, x_p)


def mamba_layer(cfg: ModelConfig, pr, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward.  x: [B, S, d_model]."""
    d_in, nh, p, n, conv_dim = dims(cfg)
    B, S, _ = x.shape
    # on a walked mesh whole over ``model`` for the split at uneven
    # points, which DTensor can only take whole; its gradient goes back
    # split as the product made it, so that w_in's gradient is not
    # computed whole on every device
    zxbcdt = reshard(x @ pr["w_in"], ("batch", "seq", None))
    z, xbc, dt = torch.split(zxbcdt, [d_in, conv_dim, nh], dim=-1)
    xbc = _conv1d(xbc, pr["conv_w"], pr["conv_b"])
    xs, b, c = torch.split(xbc, [d_in, n, n], dim=-1)
    xs = constrain(L.split_heads(xs, nh, p, "heads"),
                   ("batch", "seq", "heads", None))

    dt = F.softplus(dt.float() + pr["dt_bias"])                   # [B,S,nh]
    a = -torch.exp(pr["A_log"]) * dt                              # [B,S,nh]
    # the big SSD streams (x*dt, B, C) travel in the model dtype; the
    # decay chain (a, cumsum, exp) and the accumulators stay fp32
    xdt = (xs.float() * dt[..., None]).to(x.dtype)

    y, _ = ssd(xdt, a, b, c, cfg.ssm.chunk)
    y = y + pr["D"][None, None, :, None] * xs.float()
    y = y.reshape(B, S, d_in)
    # gated RMSNorm (mamba2's norm-before-out-proj)
    y = y * F.silu(z.float())
    y = L.rmsnorm({"scale": pr["norm"]}, y, cfg.norm_eps)
    # not among the reference's constraints: without it DTensor carries
    # w_out's row-parallel partial sum into the residual stream and on
    # to the LM head, whose product it then repeats on every ``model``
    # device (XLA's partitioner reduces it where the logits' constraint
    # asks)
    return constrain(y.to(x.dtype) @ pr["w_out"], ("batch", "seq", "embed"))


# ---------------------------------------------------------------------- #
# single-token decode (linear recurrence)
# ---------------------------------------------------------------------- #
def init_layer_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    d_in, nh, p, n, conv_dim = dims(cfg)
    ssm_state = torch.zeros((batch, nh, p, n), dtype=torch.float32,
                            device=device)
    conv_state = torch.zeros((batch, cfg.ssm.d_conv - 1, conv_dim),
                             dtype=dtype, device=device)
    return ssm_state, conv_state


def mamba_decode(cfg: ModelConfig, pr, x: torch.Tensor,
                 ssm_state: torch.Tensor, conv_state: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, 1, d_model] -> (y, new_ssm_state, new_conv_state)."""
    d_in, nh, p, n, conv_dim = dims(cfg)
    B = x.shape[0]
    zxbcdt = x @ pr["w_in"]
    z, xbc, dt = torch.split(zxbcdt, [d_in, conv_dim, nh], dim=-1)
    xbc_out = _conv1d(xbc, pr["conv_w"], pr["conv_b"], state=conv_state)
    # torch.cat promotes as jnp.concatenate does (a bf16 cache meeting an
    # fp32 model becomes fp32)
    new_conv = torch.cat([conv_state[:, 1:], xbc], dim=1)
    xs, b, c = torch.split(xbc_out[:, 0], [d_in, n, n], dim=-1)
    xs = xs.reshape(B, nh, p).float()

    dtv = F.softplus(dt[:, 0].float() + pr["dt_bias"])
    da = torch.exp(-torch.exp(pr["A_log"]) * dtv)                 # [B,nh]
    bx = (dtv[..., None] * xs)[..., None] \
        * b[:, None, None, :].float()                             # [B,nh,p,n]
    new_state = ssm_state * da[..., None, None] + bx
    y = torch.einsum("bhpn,bn->bhp", new_state, c.float()) \
        + pr["D"][None, :, None] * xs
    y = y.reshape(B, 1, d_in)
    y = y * F.silu(z.float())
    y = L.rmsnorm({"scale": pr["norm"]}, y, cfg.norm_eps)
    # as in ``mamba_layer``: not among the reference's constraints
    return constrain(y.to(x.dtype) @ pr["w_out"],
                     ("batch", "seq", "embed")), new_state, new_conv


# ---------------------------------------------------------------------- #
# model assembly
# ---------------------------------------------------------------------- #
def init(cfg: ModelConfig, gen: Optional[torch.Generator],
         device=None) -> Mamba2LM:
    """Seeded weights from ``gen`` on ``device`` (the generator's device
    by default; torch requires the two to match).  Without a generator,
    uninitialised weights for ``carry`` to load."""
    if device is None and gen is not None:
        device = gen.device
    return Mamba2LM(cfg, gen, device)


def block_fwd(cfg: ModelConfig, pr, x: torch.Tensor) -> torch.Tensor:
    return x + mamba_layer(cfg, pr["mamba"], L.norm(cfg, pr["ln"], x))


def forward(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    x = L.embed(cfg, params["embed"], tokens)
    bf = L.remat(cfg, lambda blk, h: block_fwd(cfg, blk, h))
    for blk in params["blocks"]:
        x = bf(blk, x)
    x = L.norm(cfg, params["ln_f"], x)
    return L.lm_head(cfg, params["embed"], x)


def loss_fn(cfg: ModelConfig, params,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token-mean cross entropy."""
    logits = forward(cfg, params, batch["tokens"])
    return L.softmax_xent(logits, batch["labels"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    d_in, nh, p, n, conv_dim = dims(cfg)
    nl = cfg.n_layers
    return {
        "ssm": torch.zeros((nl, batch, nh, p, n), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((nl, batch, cfg.ssm.d_conv - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def serve_step(cfg: ModelConfig, params, cache: Dict[str, torch.Tensor],
               token: torch.Tensor, pos: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """SSM decode: O(1) in sequence length (no KV cache)."""
    x = L.embed(cfg, params["embed"], token[:, None])
    sss, css = [], []
    for i, blk in enumerate(params["blocks"]):
        x, ss, cs = _decode_block(cfg, blk, x, cache["ssm"][i],
                                  cache["conv"][i])
        sss.append(ss)
        css.append(cs)
    cache = {"ssm": torch.stack(sss), "conv": torch.stack(css)}
    x = L.norm(cfg, params["ln_f"], x)
    return L.lm_head(cfg, params["embed"], x)[:, 0], cache


def _decode_block(cfg, blk, x, ss, cs):
    y, ss, cs = mamba_decode(cfg, blk["mamba"], L.norm(cfg, blk["ln"], x),
                             ss, cs)
    return x + y, ss, cs
