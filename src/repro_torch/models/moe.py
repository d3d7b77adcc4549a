"""Mixture-of-Experts transformer (grok-1, qwen2-moe): the PyTorch port of
the reference's ``models/moe.py``, forward only.

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
annotations are dropped (one device).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import Params


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
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :top_k], idx[..., :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    eid = gate_idx.reshape(*lead, t * top_k)
    onehot = F.one_hot(eid, e)                              # [..., t*k, e]
    pos = torch.cumsum(onehot, dim=-2) - onehot             # arrival order
    slot = torch.sum(pos * onehot, dim=-1)
    keep = slot < capacity
    return eid, slot, keep, gate_vals.reshape(*lead, t * top_k)


def expert_ffn(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x: [e, c, d] or [e, g, c, d] -> same shape, batched over experts
    (g = dispatch groups)."""
    if x.dim() == 4:
        eq_in, eq_out = "egcd,edf->egcf", "egcf,efd->egcd"
    else:
        eq_in, eq_out = "ecd,edf->ecf", "ecf,efd->ecd"
    h = torch.einsum(eq_in, x, p["w_in"])
    if cfg.act in ("swiglu", "geglu"):
        g = torch.einsum(eq_in, x, p["w_gate"])
        gate = F.silu(g) if cfg.act == "swiglu" else \
            F.gelu(g, approximate="tanh")
        h = gate * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum(eq_out, h, p["w_out"])


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
    xf = x.reshape(t, d)
    logits = xf.float() @ p["router"]

    g, capacity = dispatch_shape(cfg, t)
    tg = t // g
    eid, slot, keep, gate = route(logits.reshape(g, tg, e), k, capacity)

    tok_idx = torch.arange(tg * k, device=x.device) // k
    xs = xf.reshape(g, tg, d)[:, tok_idx]                   # [g, tg*k, d]
    xs = torch.where(keep[..., None], xs, 0)
    slot_c = torch.where(keep, slot, capacity)              # drop bucket
    grp = torch.arange(g, device=x.device)[:, None].expand(g, tg * k)
    buf = torch.zeros((g, e, capacity + 1, d), dtype=x.dtype,
                      device=x.device)
    buf.index_put_((grp, eid, slot_c), xs)
    buf = buf[:, :, :capacity]

    out_buf = expert_ffn(cfg, p["experts"],
                         buf.transpose(0, 1))               # [e,g,c,d]
    # combine: each assignment's output, gathered back
    y = out_buf[eid, grp, torch.clamp(slot, max=capacity - 1)]
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
    return out, aux


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
    for blk in params["blocks"]:
        x, aux = block_fwd(cfg, blk, x, pos)
        aux_total = aux_total + aux
    x = L.norm(cfg, params["ln_f"], x)
    return L.lm_head(cfg, params["embed"], x), aux_total


def loss_fn(cfg: ModelConfig, params,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Forward only: the port has no backward yet (ROADMAP.md)."""
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
