"""Mixture-of-Experts transformer (grok-1, qwen2-moe): the PyTorch port of
the reference's ``models/moe.py``.

MoE dispatch is the framework's instantiation of TeAAL's
*uniform-occupancy leader-follower partitioning* (DESIGN.md): the
router output is the leader tensor; tokens (the followers) are split
into equal-occupancy partitions per expert (capacity), and assignments
past an expert's capacity are dropped.

Supports shared (always-on) experts (qwen2-moe: 4 shared + 60 routed
top-4) and pure top-k routing (grok-1: 8 experts top-2).

The dispatch copies the reference's exactly, because it decides which
tokens drop: the group count and capacity from the shapes (Python
floats, no host sync), the top-k order on ties (lower expert first, as
``jax.lax.top_k``), the arrival-order slots, the scatter into a buffer
with one spare row for dropped assignments, and the gated combine.  The
expert products are batched matrix products, as in the reference, which
runs them outside any kernel.  The reference's ``constrain`` sharding
annotations are kept (the identity on one device).  On a mesh walked by
the dry run, the capacity scatter and the combine's gather, which
DTensor has no rule for, run on each rank's dispatch groups under
``local_map`` (``_scatter``, ``_gather``): the groups over ``data``, as
the buffer's constraint lays them, so that neither crosses a shard.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import meta
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import Params
from repro_torch.sharding.logical import (constrain, is_sharded,
                                          placements_of, reshard)


# ---------------------------------------------------------------------- #
# parameters (expert weights stacked over experts)
# ---------------------------------------------------------------------- #
def init_experts(cfg: ModelConfig, gen: Optional[torch.Generator], n: int,
                 d_expert: int, device=None) -> Params:
    """``w_in`` [n, d, d_expert], ``w_out`` [n, d_expert, d] and, for
    gated activations, ``w_gate`` [n, d, d_expert]."""
    d = cfg.d_model
    dt = L._dtype(cfg)
    p = Params()
    p.add("w_in", L._normal((n, d, d_expert), gen, device,
                            1.0 / math.sqrt(d), dt))
    p.add("w_out", L._normal((n, d_expert, d), gen, device,
                             1.0 / math.sqrt(d_expert), dt))
    if cfg.act in ("swiglu", "geglu"):
        p.add("w_gate", L._normal((n, d, d_expert), gen, device,
                                  1.0 / math.sqrt(d), dt))
    return p


def padded_expert_count(n_experts: int, tp: int = 16) -> int:
    """The reference pads no experts (its padding to a mesh multiple
    measured slower and was reverted); kept as the identity it is."""
    return n_experts


class MoELayer(Params):
    """``router`` [d, n_experts] (fp32), ``experts`` and, with shared
    experts, ``shared``."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        m = cfg.moe
        d_expert = m.d_expert or cfg.d_ff
        self.add("router", L._normal((cfg.d_model, m.n_experts), gen, device,
                                     0.02, torch.float32))
        self.experts = init_experts(cfg, gen, padded_expert_count(
            m.n_experts), d_expert, device)
        if m.n_shared:
            self.shared = init_experts(cfg, gen, m.n_shared, d_expert, device)


def init_moe_layer(cfg: ModelConfig, gen: Optional[torch.Generator],
                   device=None) -> MoELayer:
    return MoELayer(cfg, gen, device)


# ---------------------------------------------------------------------- #
# dispatch: occupancy-equalized expert capacity (leader-follower)
# ---------------------------------------------------------------------- #
def route(logits: torch.Tensor, top_k: int, capacity: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router logits [..., t, e] -> (expert_id, slot, keep, gate), each
    [..., t*k]; leading dimensions are dispatch groups, routed apart.

    ``slot`` is each (token, k)-assignment's arrival position within its
    expert, token-major and k-minor; assignments at or past ``capacity``
    are dropped.  The top k come from a stable descending sort, so tied
    probabilities keep the lower expert first, as ``jax.lax.top_k``
    orders them (``torch.topk`` does not)."""
    *lead, t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
    eid = idx[..., :top_k].reshape(*lead, t * top_k)
    onehot = F.one_hot(eid, e)                              # [..., t*k, e]
    pos = torch.cumsum(onehot, dim=-2) - onehot             # arrival order
    slot = torch.sum(pos * onehot, dim=-1)
    keep = slot < capacity
    return eid, slot, keep, gates(logits, eid, top_k)


def gates(logits: torch.Tensor, eid: torch.Tensor, top_k: int
          ) -> torch.Tensor:
    """The gates of the chosen experts ``eid`` [..., t*k] from router
    logits [..., t, e]: their softmax probabilities (fp32) over their
    sum, so that the router's gradient flows through them."""
    *lead, t, _ = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    vals = torch.gather(probs, -1, eid.reshape(*lead, t, top_k))
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return vals.reshape(*lead, t * top_k)


def expert_ffn(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x: [e, c, d] or [e, g, c, d] -> same shape, batched over experts
    (g = dispatch groups)."""
    if x.dim() == 4:
        eq_in, eq_out = "egcd,edf->egcf", "egcf,efd->egcd"
        ax_h = ("experts", "expert_group", None, "ff")
        ax_o = ("experts", "expert_group", None, None)
    else:
        eq_in, eq_out = "ecd,edf->ecf", "ecf,efd->ecd"
        ax_h = ("experts", "expert_cap", "ff")
        ax_o = ("experts", "expert_cap", None)
    h = constrain(torch.einsum(eq_in, x, p["w_in"]), ax_h)
    if cfg.act in ("swiglu", "geglu"):
        g = torch.einsum(eq_in, x, p["w_gate"])
        gate = F.silu(g) if cfg.act == "swiglu" else \
            F.gelu(g, approximate="tanh")
        h = gate * h
    else:
        h = F.gelu(h, approximate="tanh")
    return constrain(torch.einsum(eq_out, h, p["w_out"]), ax_o)


def dispatch_shape(cfg: ModelConfig, t: int) -> Tuple[int, int]:
    """(groups, capacity per group) for ``t`` tokens: 16 groups when
    ``t`` splits into 16 groups of at least ``top_k`` tokens each, the
    capacity rounded up to a multiple of 64 above 64 (the reference's
    arithmetic, with its Python float and floor division)."""
    m = cfg.moe
    k = m.top_k
    g = 16 if (t % 16 == 0 and t >= 16 * k) else 1
    tg = t // g
    capacity = max(1, int(m.capacity_factor * tg * k // m.n_experts))
    capacity = -(-capacity // 64) * 64 if capacity > 64 else capacity
    return g, capacity


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [b, s, d] -> ([b, s, d], aux_loss).

    Scatter/gather dispatch: each group's kept assignments are written
    into per-expert capacity buffers at their occupancy slot (every
    kept (expert, slot) pair once; dropped ones, zeroed, into a spare
    row that is sliced off), the expert FFNs run batched, and outputs
    are gathered back and gate-combined."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    k = m.top_k
    e = m.n_experts
    # the tokens split as the buffer's constraint splits the groups
    # (over ``data``), before the reshape to groups: DTensor cannot
    # split 16 groups over the 32 token shards of ``pod`` x ``data``
    xf = constrain(x.reshape(t, d), ("expert_group", None))
    logits = xf.float() @ p["router"]

    g, capacity = dispatch_shape(cfg, t)
    tg = t // g
    eid, slot, keep, gate = route(logits.reshape(g, tg, e), k, capacity)

    # each token k times, as a broadcast (DTensor's rule for an index's
    # gradient fails in some torch releases)
    xs = xf.reshape(g, tg, 1, d).expand(g, tg, k, d).reshape(
        g, tg * k, d)                                       # [g, tg*k, d]
    xs = torch.where(keep[..., None], xs, 0)
    slot_c = torch.where(keep, slot, capacity)              # drop bucket
    buf = _scatter(xs, eid, slot_c, e, capacity)
    buf = constrain(buf, ("expert_group", "experts", None, None))

    out_buf = expert_ffn(cfg, p["experts"],
                         buf.transpose(0, 1))               # [e,g,c,d]
    # combine: each assignment's output, gathered back
    y = _gather(out_buf, eid, torch.clamp(slot, max=capacity - 1))
    y = y * (gate * keep).to(y.dtype)[..., None]            # [g, tg*k, d]
    out = torch.sum(y.reshape(g, tg, k, d), dim=2).reshape(b, s, d)

    if m.n_shared:
        shared = expert_ffn(cfg, p["shared"],
                            xf[None].expand(m.n_shared, t, d))
        out = out + shared.sum(0).reshape(b, s, d)
    # load-balance auxiliary loss (Switch-style)
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = torch.mean(
        (F.one_hot(eid.reshape(t * k), e).float()
         * keep.reshape(t * k)[:, None]).reshape(t, k, e).sum(1), dim=0)
    frac_probs = torch.mean(probs, dim=0)
    aux = e * torch.sum(frac_tokens * frac_probs)
    # the reference's constraint, its gradient back in the groups'
    # layout (over ``data``), which the reshape from groups can take apart
    return reshard(out, ("batch", "seq", "embed")), aux


def _scatter(xs: torch.Tensor, eid: torch.Tensor, slot: torch.Tensor,
             e: int, capacity: int) -> torch.Tensor:
    """Each group's kept assignments xs [g, t, d] written into its
    per-expert capacity buffer at (eid, slot) [g, t]: [g, e, capacity,
    d] (``slot == capacity``, a dropped one, lands in a spare row that
    is sliced off).  On DTensors, each rank's groups (``_groups``)."""
    if is_sharded(xs):
        places = _groups(eid.shape[0], 0)
        return meta.local(lambda a, b, c: _scatter(a, b, c, e, capacity),
                          (xs, eid, slot), (places,) * 3, places)
    g, t, d = xs.shape
    grp = torch.arange(g, device=xs.device)[:, None].expand(g, t)
    buf = torch.zeros((g, e, capacity + 1, d), dtype=xs.dtype,
                      device=xs.device)
    buf.index_put_((grp, eid, slot), xs)
    return buf[:, :, :capacity]


def _gather(out_buf: torch.Tensor, eid: torch.Tensor, slot: torch.Tensor
            ) -> torch.Tensor:
    """Each assignment's row of the experts' outputs out_buf [e, g, c,
    d] at (eid, its group, slot) [g, t]: [g, t, d].  On DTensors, each
    rank's groups (``_groups``), the experts whole."""
    if is_sharded(out_buf):
        places = _groups(eid.shape[0], 0)
        return meta.local(_gather, (out_buf, eid, slot),
                          (_groups(eid.shape[0], 1), places, places), places)
    g, t = eid.shape
    grp = torch.arange(g, device=eid.device)[:, None].expand(g, t)
    return out_buf[eid, grp, slot]


def _groups(g: int, dim: int):
    """The placements of a tensor whose dim ``dim`` holds the ``g``
    dispatch groups: split as the buffer's constraint splits them
    (``expert_group``), whole on every other axis."""
    return placements_of((1,) * dim + (g,), (None,) * dim + ("expert_group",))


# ---------------------------------------------------------------------- #
# model assembly: transformer with MoE FFNs
# ---------------------------------------------------------------------- #
class MoEBlock(Params):
    """Pre-norm residual block: ``ln1``, ``attn``, ``ln2``, ``moe``."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.ln1 = L.init_rmsnorm(cfg, device=device)
        self.attn = L.init_attention(cfg, gen, device)
        self.ln2 = L.init_rmsnorm(cfg, device=device)
        self.moe = MoELayer(cfg, gen, device)


class MoELM(Params):
    """The language model: ``embed``, ``blocks`` (one per layer) and
    ``ln_f``."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.embed = L.init_embedding(cfg, gen, device)
        self.blocks = nn.ModuleList(MoEBlock(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.init_rmsnorm(cfg, device=device)


def init(cfg: ModelConfig, gen: Optional[torch.Generator],
         device=None) -> MoELM:
    """Seeded weights from ``gen`` on ``device`` (the generator's device
    by default); without a generator, uninitialised weights for
    ``carry`` to load."""
    if device is None and gen is not None:
        device = gen.device
    return MoELM(cfg, gen, device)


def block_fwd(cfg: ModelConfig, p, x: torch.Tensor, pos: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x + L.attention(cfg, p["attn"], L.norm(cfg, p["ln1"], x), pos)
    y, aux = moe_ffn(cfg, p["moe"], L.norm(cfg, p["ln2"], x))
    return x + y, aux


def forward(cfg: ModelConfig, params, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [b, s] -> (logits [b, s, padded vocab], summed aux loss)."""
    x = L.embed(cfg, params["embed"], tokens)
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    bf = L.remat(cfg, lambda blk, h: block_fwd(cfg, blk, h, pos))
    for blk in params["blocks"]:
        x, aux = bf(blk, x)
        aux_total = aux_total + aux
    x = L.norm(cfg, params["ln_f"], x)
    return L.lm_head(cfg, params["embed"], x), aux_total


def loss_fn(cfg: ModelConfig, params,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Cross entropy plus the router's auxiliary loss (weighted, a
    layer's mean)."""
    logits, aux = forward(cfg, params, batch["tokens"])
    return (L.softmax_xent(logits, batch["labels"])
            + cfg.moe.router_aux_weight * aux / cfg.n_layers)


# ---------------------------------------------------------------------- #
# decode
# ---------------------------------------------------------------------- #
init_cache = T.init_cache


def decode_block(cfg: ModelConfig, p, x: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor, pos: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    a, ck, cv = L.attention_decode(cfg, p["attn"], L.norm(cfg, p["ln1"], x),
                                   ck, cv, pos)
    x = x + a
    y, _ = moe_ffn(cfg, p["moe"], L.norm(cfg, p["ln2"], x))
    return x + y, ck, cv


def serve_step(cfg: ModelConfig, params, cache: Dict[str, torch.Tensor],
               token: torch.Tensor, pos: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step (the dense model's, with MoE FFNs): the batch's
    slots are the tokens routed together."""
    return T.serve_step(cfg, params, cache, token, pos, block=decode_block)
