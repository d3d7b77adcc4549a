"""Composable transformer building blocks (PyTorch port of the
reference's ``models/layers.py``): norms, rotary embeddings, attention
(GQA, optional qk-norm / qkv-bias), the FFN, embeddings, the LM head and
the loss.

Parameters live in ``Params`` modules under the reference's names, and
``p["name"]`` reads them as the reference reads its pytree, so the
functions below keep the reference's signatures.  They call
``sharding.logical.constrain`` where the reference does, with its
logical axes and its ``seq_parallel`` switch: the identity on one
device; on a mesh walked by the dry run (DTensors on ``meta``) the
redistribution that decides the step's collectives.  The reference's
three constraints inside its attention (the repeated keys and values
over ``kv_seq``, the logits over heads or ``kv_seq``) have no tensor
here: the flash kernel's own split over the mesh stands for them
(``kernels/flash_attention.Split``: heads over ``model``, else the
query rows).

``mha`` runs on the hand-written ``flash_attention`` kernel (its plain
version for tensors on the CPU) where the reference computes attention
in plain jnp, blocked by ``cfg.attn_chunk``: the kernel streams the keys
itself, so the port has no chunk loop and no KV repeat.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.sharding.logical import constrain, is_sharded, reshard
from repro_torch.sharding.logical import spec_for as constrain_spec

#: ModelConfig.dtype -> torch dtype
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class Params(nn.Module):
    """An ``nn.Module`` whose parameters and submodules read by name,
    ``p["w_in"]``, like the reference's parameter dictionaries.
    Parameters are created frozen, so the inference paths build no
    autograd graph; a train step (``launch/steps.make_train_step``)
    makes them trainable with ``requires_grad_()``."""

    def add(self, name: str, value: torch.Tensor) -> None:
        self.register_parameter(name, nn.Parameter(value,
                                                   requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def remat(cfg: ModelConfig, fn):
    """``fn`` as a family's forward runs one block: under autograd with
    ``cfg.remat`` (grad mode on, and the block's input or one of its
    parameters requiring a gradient), through ``torch.utils.checkpoint`` (non-reentrant),
    which keeps only the block's inputs and recomputes the rest in the
    backward, as the reference wraps its blocks in ``jax.checkpoint``;
    otherwise as it is."""
    def run(*args):
        if cfg.remat and torch.is_grad_enabled() and _trains(args):
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)
    return run


def _trains(args) -> bool:
    """Whether a block's arguments take part in a gradient: a tensor that
    requires one, or a module with a trainable parameter."""
    for a in args:
        if isinstance(a, torch.Tensor) and a.requires_grad:
            return True
        if isinstance(a, nn.Module) and any(p.requires_grad
                                            for p in a.parameters()):
            return True
    return False


def _normal(shape, gen: Optional[torch.Generator], device, scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    """Seeded N(0, scale^2) weights from ``gen``; without a generator,
    uninitialised storage for weights that are loaded next (``carry``)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, device=device)
            * scale).to(dtype)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as JAX promotes a
    bf16 activation meeting an fp32 weight (whisper's bf16 frames in an
    fp32 model); torch refuses mixed-dtype products."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# ---------------------------------------------------------------------- #
# norms
# ---------------------------------------------------------------------- #
def init_rmsnorm(cfg: ModelConfig, dim: Optional[int] = None,
                 device=None) -> Params:
    p = Params()
    if not cfg.nonparam_ln:
        p.add("scale", torch.ones(dim or cfg.d_model, dtype=torch.float32,
                                  device=device))
    return p


def _stat(t: torch.Tensor) -> torch.Tensor:
    """A norm's statistic over the last dim, constrained to the batch's
    layout: on a walked mesh a partial sum over a split dim (Mamba2's
    gated norm over its heads) is all-reduced there, as XLA reduces it,
    where DTensor would reduce-scatter it along the sequence and carry
    that split into the products after the norm."""
    return constrain(t, ("batch",) + (None,) * (t.dim() - 1))


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(_stat(torch.mean(x * x, dim=-1, keepdim=True)) + eps)
    if "scale" in p:
        # whole on every device (its spec splits it over ``model``), so
        # that the activation keeps its own layout, as XLA keeps it
        # under the residual stream's constraint
        y = y * constrain(p["scale"], (None,))
    return y.to(dt)


def layernorm_np(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Non-parametric LayerNorm (olmo): normalize, no scale/bias."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dt)


def norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.nonparam_ln:
        return layernorm_np(x, cfg.norm_eps)
    return rmsnorm(p, x, cfg.norm_eps)


# ---------------------------------------------------------------------- #
# rotary position embeddings
# ---------------------------------------------------------------------- #
def rope_freqs(cfg: ModelConfig, device=None) -> torch.Tensor:
    h = cfg.hdim
    return 1.0 / (cfg.rope_theta ** (torch.arange(
        0, h, 2, dtype=torch.float32, device=device) / h))


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; pos: [..., seq].  Half-split
    (not interleaved) rotation; angles in fp32, each half cast to
    ``x``'s dtype before the concat, as in the reference."""
    angles = pos[..., :, None, None].float() * freqs        # [...,s,1,h/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    dt = x.dtype
    return torch.cat([(x1 * cos - x2 * sin).to(dt),
                      (x1 * sin + x2 * cos).to(dt)], dim=-1)


# ---------------------------------------------------------------------- #
# attention (GQA, optional qk-norm / qkv-bias)
# ---------------------------------------------------------------------- #
def init_attention(cfg: ModelConfig, gen: Optional[torch.Generator],
                   device=None) -> Params:
    d, h, nh, nkv = cfg.d_model, cfg.hdim, cfg.n_heads, cfg.n_kv_heads
    s = 1.0 / math.sqrt(d)
    dt = _dtype(cfg)
    p = Params()
    p.add("wq", _normal((d, nh * h), gen, device, s, dt))
    p.add("wk", _normal((d, nkv * h), gen, device, s, dt))
    p.add("wv", _normal((d, nkv * h), gen, device, s, dt))
    p.add("wo", _normal((nh * h, d), gen, device, s, dt))
    if cfg.qkv_bias:
        for name, n in (("bq", nh * h), ("bk", nkv * h), ("bv", nkv * h)):
            p.add(name, torch.zeros(n, dtype=dt, device=device))
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p.add(name, torch.ones(h, dtype=torch.float32, device=device))
    return p


def _qkv(cfg: ModelConfig, p, x: torch.Tensor, pos: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    nh, nkv, h = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    q = _mm(x, p["wq"])
    k = _mm(x, p["wk"])
    v = _mm(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_heads(q, nh, h, "heads")
    k = split_heads(k, nkv, h, "kv_heads")
    v = split_heads(v, nkv, h, "kv_heads")
    if cfg.qk_norm:
        q = rmsnorm({"scale": p["q_norm"]}, q, cfg.norm_eps)
        k = rmsnorm({"scale": p["k_norm"]}, k, cfg.norm_eps)
    freqs = rope_freqs(cfg, x.device)
    q = constrain(apply_rope(q, pos, freqs), ("batch", "seq", "heads", None))
    k = constrain(apply_rope(k, pos, freqs),
                  ("batch", "seq", "kv_heads", None))
    v = constrain(v, ("batch", "seq", "kv_heads", None))
    return q, k, v


def split_heads(t: torch.Tensor, n: int, h: int, axis: str) -> torch.Tensor:
    """[..., n * h] -> [..., n, h].  A DTensor whose last dim is split
    where the ``n`` heads are not (a TP-sharded projection onto fewer
    heads than the ``model`` axis) is first made whole in that dim, as
    the heads' constraint wants it (``axis``: its logical name): DTensor
    has no rule for a reshape that would split a head.  Its gradient
    goes back split as the projection made it (``logical.reshard``), so
    that the weight's gradient is not computed whole on every device.
    A plain tensor (one card) is only reshaped: it has no layout to
    decide, and the spec would cost each call microseconds of host
    time."""
    if is_sharded(t):
        lead = ("batch",) + (None,) * (t.dim() - 2)
        if constrain_spec(t.shape[:-1] + (n, h),
                          lead + (axis, None))[-2] is None:
            t = reshard(t, lead + (None,))
    return t.reshape(*t.shape[:-1], n, h)


def merge_heads(t: torch.Tensor, axis: str) -> torch.Tensor:
    """[b, s, n, h] -> [b, s, n * h].  On DTensors the merged dim is
    split over ``model`` for the row-parallel product after it: as the
    ``n`` heads are (``axis``: their logical name), or, where they do
    not split the ``model`` axis and the flash kernel split the
    queries' sequence instead, by an all-to-all from the sequence
    (``logical.reshard``), whose gradient goes back to the sequence
    before the reshape to heads (DTensor has no rule for a reshape that
    would split a head; and a product that folds the batch and a split
    sequence into one dim makes a strided shard, whose redistribution
    plans DTensor searches for minutes).  A plain tensor (one card) is
    only reshaped, as in ``split_heads``."""
    b, s, n, h = t.shape
    out = t.reshape(b, s, n * h)
    if not is_sharded(t):
        return out
    if constrain_spec((b, s, n), ("batch", "seq", axis))[-1] is not None:
        return constrain(out, ("batch", "seq", axis))
    return reshard(out, ("batch", "seq", axis))


def mha(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        causal: bool = True) -> torch.Tensor:
    """Attention over [b, sq, nh, h] x [b, sk, nkv, h] -> [b, sq, nh, h]:
    one ``flash_attention`` call on [b, h, s, d] views (the kernel folds
    each query head onto its KV group and writes its output in ``q``'s
    layout).  The mask is top-left aligned, as the reference's without
    ``q_offset``, which no caller passes.

    In bf16 the reference rounds the softmax weights to ``v``'s dtype
    before the PV product, and so does the kernel (P = exp(s - m) in
    bf16 on the tensor cores, the division by the fp32 sum at the end);
    the plain version, which the CPU takes, keeps them in fp32.  In fp32
    all agree to reassociation."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)


def attention(cfg: ModelConfig, p, x: torch.Tensor, pos: torch.Tensor,
              causal: bool = True,
              kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> torch.Tensor:
    """Full attention block (no cache).  ``kv`` overrides keys/values for
    cross-attention (whisper decoder): the mask is then non-causal and
    only ``q`` takes RoPE at ``pos``.

    The kernel takes q, k and v of one dtype, so ``q`` and ``kv`` are
    cast to their promoted dtype first.  For a bf16 cross cache in an
    fp32 model the reference promotes in the QK product and then rounds
    the softmax weights to bf16 for PV; here PV stays fp32, so the two
    agree to bf16 rounding there, not to fp32 reassociation."""
    if cfg.seq_parallel:
        # the SP all-gather: un-shard seq before the column-parallel QKV
        x = constrain(x, ("batch", "seq", "embed"))
    q, k, v = _qkv(cfg, p, x, pos)
    if kv is not None:
        k, v = kv
        causal = False
        dt = torch.promote_types(q.dtype, k.dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
    out = merge_heads(mha(cfg, q, k, v, causal=causal), "heads")
    return constrain(_mm(out, p["wo"]).to(x.dtype), _res_axes(cfg))


def _res_axes(cfg: ModelConfig):
    """Residual-stream axes: sequence-sharded over ``model`` when
    Megatron-style sequence parallelism is on."""
    return ("batch", "sp" if cfg.seq_parallel else "seq", "embed")


def attention_decode(cfg: ModelConfig, p, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode with a KV cache, in plain torch (the reference
    computes it outside any kernel).

    x: [b, 1, d]; cache_[kv]: [b, S, nkv, h]; pos: [b] absolute position.
    The reference writes the new key and value with a one-hot blend;
    here they are copied in place into slot ``pos`` of each row, which
    gives the same values without rewriting the cache.  A cache of a
    narrower dtype than the model's is widened first, as the blend
    promotes it in the reference."""
    b, _, d = x.shape
    q, k_new, v_new = _qkv(cfg, p, x, pos[:, None])
    wide = torch.promote_types(cache_k.dtype, k_new.dtype)
    if cache_k.dtype != wide:
        cache_k, cache_v = cache_k.to(wide), cache_v.to(wide)
    S = cache_k.shape[1]
    # a cache split over ``kv_seq`` takes the write on each rank's slots
    # (DTensor has no rule for the flat view); one card keeps the plain
    # write, which reads no slot
    if is_sharded(cache_k):
        _write_sharded(cache_k, k_new, pos)
        _write_sharded(cache_v, v_new, pos)
    else:
        slot = torch.arange(b, device=x.device) * S + pos
        cache_k.view(b * S, *cache_k.shape[2:]).index_copy_(
            0, slot, k_new[:, 0].to(wide))
        cache_v.view(b * S, *cache_v.shape[2:]).index_copy_(
            0, slot, v_new[:, 0].to(wide))
    cache_k = constrain(cache_k, ("batch", "kv_seq", "kv_heads", None))
    cache_v = constrain(cache_v, ("batch", "kv_seq", "kv_heads", None))
    # mask out cache slots beyond pos
    nh, nkv, h = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    group = nh // nkv
    # the one query's heads whole on every device, as the cache's kv
    # heads are (its slots take ``model``): a query split over heads
    # would make einsum fold a sharded head dim into its batch, which
    # DTensor can only express as a strided shard, and its search for a
    # redistribution plan of one takes minutes on a 3-D mesh
    q = constrain(q, ("batch", None, None, None))
    qr = q.reshape(b, nkv, group, h)
    logits = torch.einsum("bkgh,bskh->bkgs", qr.float(),
                          cache_k.float()) / math.sqrt(h)
    valid = torch.arange(S, device=x.device)[None] <= pos[:, None]
    logits = torch.where(valid[:, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", w, cache_v).reshape(b, 1, nh * h)
    # not among the reference's constraints: without it DTensor carries
    # wo's row-parallel partial sum through the residual add and the
    # norm (linear in it) into the FFN, whose products it then repeats
    # on every ``model`` device
    return constrain(_mm(out, p["wo"]), _res_axes(cfg)), cache_k, cache_v


def _write_sharded(cache: torch.Tensor, new: torch.Tensor,
                   pos: torch.Tensor) -> None:
    """``attention_decode``'s in-place write of ``new`` [b, 1, kv, h]
    into slot ``pos`` of a cache DTensor [b, S, kv, h] sharded over
    ``kv_seq`` (DTensor has no rule for a view that merges a sharded
    dim): on each rank's shard, the rows whose slot it holds take the
    new entry, the others keep theirs."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels import meta

    def body(c, n, p):
        b, s = c.shape[:2]
        start = _shard_start(cache, 1, s)
        local = p.long() - start
        mine = (local >= 0) & (local < s)
        slot = torch.arange(b, device=c.device) * s + local.clamp(0, s - 1)
        flat = c.view(b * s, *c.shape[2:])
        kept = flat.index_select(0, slot)
        flat.index_copy_(0, slot, torch.where(
            mine[:, None, None], n[:, 0].to(c.dtype), kept))
        return c
    places = tuple(cache.placements)
    # the new entry is split as the cache is, but for the slots
    new_places = tuple(Replicate() if isinstance(q, Shard) and q.dim == 1
                       else q for q in places)
    pos_places = tuple(q if isinstance(q, Shard) and q.dim == 0
                       else Replicate() for q in places)
    meta.local(body, (cache, new, pos), (places, new_places, pos_places),
               places)


def _shard_start(t, dim: int, size: int) -> int:
    """The first index along ``dim`` of this rank's shard of the DTensor
    ``t`` (``size`` rows a shard; a dim over several mesh axes is split
    by them major to minor)."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    index, stride = 0, size
    for i in reversed(range(mesh.ndim)):
        p = t.placements[i]
        if isinstance(p, Shard) and p.dim == dim:
            index += mesh.get_local_rank(i) * stride
            stride *= mesh.size(i)
    return index


# ---------------------------------------------------------------------- #
# FFN
# ---------------------------------------------------------------------- #
def init_ffn(cfg: ModelConfig, gen: Optional[torch.Generator],
             device=None, d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = _dtype(cfg)
    p = Params()
    p.add("w_in", _normal((d, f), gen, device, 1.0 / math.sqrt(d), dt))
    p.add("w_out", _normal((f, d), gen, device, 1.0 / math.sqrt(f), dt))
    if cfg.act in ("swiglu", "geglu"):
        p.add("w_gate", _normal((d, f), gen, device, 1.0 / math.sqrt(d), dt))
    return p


def ffn(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """swiglu, geglu (grok-1-style gated gelu) or gelu; gelu is the tanh
    approximation, ``jax.nn.gelu``'s default."""
    if cfg.seq_parallel:
        x = constrain(x, ("batch", "seq", "embed"))
    h = constrain(_mm(x, p["w_in"]), ("batch", "seq", "ff"))
    if cfg.act in ("swiglu", "geglu"):
        # the gate takes h's constraint, which XLA propagates to it
        # through their product and DTensor does not
        g = constrain(_mm(x, p["w_gate"]), ("batch", "seq", "ff"))
    if cfg.act == "swiglu":
        h = F.silu(g) * h
    elif cfg.act == "geglu":
        h = F.gelu(g, approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return constrain(_mm(h, p["w_out"]).to(x.dtype), _res_axes(cfg))


# ---------------------------------------------------------------------- #
# embeddings / head
# ---------------------------------------------------------------------- #
def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rounded up to a multiple of 256, as in the reference; pad
    logits are masked to -1e30 in ``lm_head``."""
    return -(-cfg.vocab // 256) * 256


def init_embedding(cfg: ModelConfig, gen: Optional[torch.Generator],
                   device=None) -> Params:
    dt = _dtype(cfg)
    pv = padded_vocab(cfg)
    p = Params()
    p.add("tok", _normal((pv, cfg.d_model), gen, device, 0.02, dt))
    if not cfg.tie_embeddings:
        p.add("head", _normal((cfg.d_model, pv), gen, device, 0.02, dt))
    return p


def embed(cfg: ModelConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' rows of the table, through ``F.embedding``: on a
    walked mesh its sharding rule keeps a vocab-sharded table where it
    is (each device looks up the rows it holds, a partial sum reduced by
    the constraint), where DTensor's rule for indexing gathers the whole
    table, and in some torch releases fails on its gradient."""
    return constrain(F.embedding(tokens, p["tok"]),
                     ("batch", "seq", "embed"))


def lm_head(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Logits over the PADDED vocab (pad positions masked to -1e30 so
    softmax/xent/argmax are exact); callers may slice [..., :vocab]."""
    if cfg.seq_parallel:
        # the SP all-gather before the vocab-parallel product, as the
        # logits' constraint wants the sequence whole
        x = constrain(x, ("batch", "seq", "embed"))
    w = p["head"] if "head" in p else p["tok"].T
    logits = constrain(x @ w, ("batch", "seq", "vocab"))
    pv = logits.shape[-1]
    if pv != cfg.vocab:
        pad = torch.arange(pv, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy in fp32.  On DTensors the gold logit is
    the reference's masked reduction (a compare and a sum keep the
    vocab axis sharded; DTensor's rule for a gather along it fails).
    One card keeps the gather, which reads one logit a token where the
    masked sum reads and compares them all."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    if is_sharded(logits):
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.sum(torch.where(labels[..., None] == vocab, logits,
                                     0.0), dim=-1)
    else:
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)
