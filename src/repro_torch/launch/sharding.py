"""Shardings for params / batches / caches on a mesh (the reference's
``launch/sharding.py``).

Parameter sharding policy (the compiled form of the TeAAL mapping's
spatial ranks, DESIGN.md):
  * TP: the last dimension divisible by the ``model`` axis size is
    sharded over ``model`` (matmul contracting/output dims);
  * FSDP/ZeRO: the largest *remaining* dimension divisible by the
    ``data`` axis size is sharded over ``data`` -- optimizer states
    inherit the param spec, so states are fully sharded too;
  * pods: parameters are replicated across the ``pod`` axis (pure DP
    between pods; gradient all-reduce over ``pod`` is the inter-pod
    collective the roofline's third term sees).

Divisibility-aware: dimensions that do not divide stay replicated
(e.g. granite's single KV head never shards over the 16-way model
axis).

**The layout differs from the reference's scan layout.**  The
reference stacks each layer's tensor into one array with a leading
layer dimension (``scan_layers=True``), and its FSDP rule may shard
that dimension: Grok-1's stacked router [64, 6144, 8] gets
``P('data', 'model', None)``, Mamba2-1.3B's stacked ``conv_w`` [48, 4,
4352] ``P('data', None, 'model')``.  The port keeps one tensor a layer,
as the reference does with ``scan_layers=False``, so it has no such
dimension to shard: its specs equal that layout's.

Specs are computed for any mesh, abstract ones included (the 16 x 16
and 2 x 16 x 16 production meshes).  ``place`` puts tensors on a real
mesh: on a one-device mesh each whole on that device; a mesh of more
devices raises, since the port runs a step on one device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.mesh import Mesh, mesh_axis_sizes
from repro_torch.sharding.logical import AxisRules
from repro_torch.sharding.logical import PartitionSpec as P

#: a module (its ``named_parameters()``) or a nested name -> tensor dict
#: (an optimizer state)
Params = Union[nn.Module, Dict[str, Any]]


# ---------------------------------------------------------------------- #
# activation rules (TeAAL spacetime -> mesh axes)
# ---------------------------------------------------------------------- #
def train_rules() -> AxisRules:
    return AxisRules({
        "batch": ("pod", "data"),
        "seq": (),
        "embed": (),
        "heads": ("model",),
        "kv_heads": ("model",),
        "ff": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "expert_cap": ("data",),
        "expert_group": ("data",),
        "sp": ("model",),
        "kv_seq": ("model",),
        "state": (),
    })


def decode_rules() -> AxisRules:
    """Decode: the KV cache's sequence rank is the huge dimension --
    shard it over (data, model); batch over pod."""
    return AxisRules({
        "batch": ("pod", "data"),
        "seq": (),
        "embed": (),
        "heads": ("model",),
        "kv_heads": ("model",),
        "ff": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "expert_cap": ("data",),
        "expert_group": ("data",),
        "sp": ("model",),
        "kv_seq": ("data", "model"),
        "state": ("model",),
    })


def rules_for(kind: str) -> AxisRules:
    return decode_rules() if kind == "decode" else train_rules()


# ---------------------------------------------------------------------- #
# parameter shardings
# ---------------------------------------------------------------------- #
def param_pspec(shape: Tuple[int, ...], tp: int, dp: int,
                skip_leading: bool = True) -> P:
    """TP on the last divisible dim, FSDP on the largest remaining.  A
    tensor of three or more dims never takes TP on its first (the
    reference's scan layer dim; in the port an expert or head dim)."""
    spec: list = [None] * len(shape)
    start = 1 if (skip_leading and len(shape) >= 3) else 0
    if tp > 1:
        for i in reversed(range(start, len(shape))):
            if shape[i] % tp == 0 and shape[i] >= tp:
                spec[i] = "model"
                break
    if dp > 1:
        cands = [i for i in range(len(shape))
                 if spec[i] is None and shape[i] % dp == 0
                 and shape[i] >= dp]
        if cands:
            i = max(cands, key=lambda j: shape[j])
            spec[i] = "data"
    return P(*spec)


def _leaf_spec(leaf: str, shape: Tuple[int, ...], tp: int, dp: int) -> P:
    """The spec of a tensor whose name ends in ``leaf``."""
    if leaf == "tok":                       # [vocab, d]
        return P("model" if tp > 1 and shape[0] % tp == 0 else None,
                 "data" if dp > 1 and shape[1] % dp == 0 else None)
    if leaf == "head":                      # [d, vocab]
        return P("data" if dp > 1 and shape[0] % dp == 0 else None,
                 "model" if tp > 1 and shape[1] % tp == 0 else None)
    if leaf in ("w_out", "wo"):
        # down-projections contract over the TP-sharded hidden (ff /
        # heads) dim: TP belongs on dim -2 (Megatron row parallel ->
        # local partial matmul + one all-reduce), NOT on the output dim
        # (which would force a full all-gather of the ff-sharded
        # activations first).
        spec: list = [None] * len(shape)
        if tp > 1 and shape[-2] % tp == 0:
            spec[-2] = "model"
        cands = [i for i in range(len(shape))
                 if spec[i] is None and shape[i] % dp == 0
                 and shape[i] >= dp]
        if dp > 1 and cands:
            spec[max(cands, key=lambda j: shape[j])] = "data"
        return P(*spec)
    return param_pspec(shape, tp, dp)


def param_pspecs(params: Params, mesh: Mesh, fsdp: bool = True
                 ) -> Dict[str, Any]:
    """Path-aware parameter specs: name -> spec over a module's
    ``named_parameters()``, or a dict of the same nesting as a name ->
    tensor dict (an optimizer state: ``{"step", "m": {name: tensor},
    ...}``).  A tensor's rule follows the last component of its dotted
    name, as the reference's follows the last key of its path.

    The embedding table is the one tensor the generic heuristic gets
    wrong: it must be sharded on the VOCAB dim (so the tied lm-head
    contraction yields vocab-sharded logits without a reshard), not on
    d_model.  Everything else uses :func:`param_pspec`.

    ``fsdp=False`` (decode/serving): params are TP-sharded only and
    replicated across data -- there is no optimizer state to amortize,
    and FSDP would all-gather every parameter once per generated token.
    """
    sizes = mesh_axis_sizes(mesh)
    tp = sizes.get("model", 1)
    dp = sizes.get("data", 1) if fsdp else 1

    def walk(tree: Dict[str, Any]) -> Dict[str, Any]:
        return {k: walk(v) if isinstance(v, dict) else
                _leaf_spec(k.split(".")[-1], tuple(v.shape), tp, dp)
                for k, v in tree.items()}

    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return walk(params)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of jax's ``NamedSharding``)."""
    mesh: Mesh
    spec: P

    def place(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on the mesh: whole on its one device.  An abstract mesh
        or a mesh of more devices raises: the port runs a step on one
        device and has no sharded tensor."""
        if self.mesh.abstract:
            raise ValueError("an abstract mesh places nothing: it only "
                             "computes specs")
        if self.mesh.size > 1:
            raise NotImplementedError(
                f"placing on a mesh of {self.mesh.size} devices "
                f"({self.mesh.shape}): the port runs a step on one device")
        return t.to(self.mesh.devices[0])


def named_shardings(pspecs: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """A nested dict of specs as ``NamedSharding``s on ``mesh``."""
    return {k: named_shardings(v, mesh) if isinstance(v, dict)
            else NamedSharding(mesh, v) for k, v in pspecs.items()}


def param_shardings(params: Params, mesh: Mesh) -> Dict[str, Any]:
    """``param_pspecs`` as ``NamedSharding``s on ``mesh``."""
    return named_shardings(param_pspecs(params, mesh), mesh)


def place(tree: Params, shardings: Dict[str, Any]) -> Params:
    """Each tensor of ``tree`` placed by its sharding (``NamedSharding.
    place``): a module's parameters moved in place (the module is
    returned), a dict's tensors returned in a dict of the same
    nesting."""
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for name, p in tree.named_parameters():
                moved = shardings[name].place(p.data)
                if moved is not p.data:
                    p.data = moved
        return tree
    return {k: place(v, shardings[k]) if isinstance(v, dict)
            else shardings[k].place(v) for k, v in tree.items()}


# ---------------------------------------------------------------------- #
# batch / cache / token shardings
# ---------------------------------------------------------------------- #
def _dims_spec(shape: Tuple[int, ...], logical: Tuple[Optional[str], ...],
               mesh: Mesh, rules: AxisRules) -> P:
    sizes = mesh_axis_sizes(mesh)
    used: set = set()
    parts = []
    for dim, name in zip(shape, logical):
        axes = [a for a in rules.axes_for(name)
                if a in sizes and a not in used]
        keep, prod = [], 1
        for a in axes:
            if dim % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        used.update(keep)
        parts.append(None if not keep
                     else keep[0] if len(keep) == 1 else tuple(keep))
    return P(*parts)


def batch_pspecs(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh
                 ) -> Dict[str, P]:
    rules = rules_for(shape.kind)
    b, s = shape.global_batch, shape.seq_len
    out = {
        "tokens": _dims_spec((b, s), ("batch", "seq"), mesh, rules),
        "labels": _dims_spec((b, s), ("batch", "seq"), mesh, rules),
    }
    if cfg.family == "vlm":
        out["patches"] = _dims_spec((b, cfg.n_patches, cfg.d_model),
                                    ("batch", "seq", "embed"), mesh, rules)
    if cfg.family == "encdec":
        out["frames"] = _dims_spec((b, cfg.enc_frames, cfg.d_model),
                                   ("batch", "seq", "embed"), mesh, rules)
    return out


def cache_pspecs(cfg: ModelConfig, batch: int, max_len: int, mesh: Mesh
                 ) -> Dict[str, P]:
    """PartitionSpec per decode-cache entry, by family (the cache's
    shapes from its ``meta`` counterpart: nothing is allocated)."""
    from repro_torch.launch.steps import cache_specs
    rules = decode_rules()
    cache = cache_specs(cfg, batch, max_len)

    def leaf_spec(path: str, x) -> P:
        nd = len(x.shape)
        if path in ("k", "v", "xk", "xv"):       # [L, b, s, kv, h]
            return _dims_spec(tuple(x.shape),
                              (None, "batch", "kv_seq", "kv_heads", None),
                              mesh, rules)
        if path == "ssm":                        # [L(,m), b, h, p, n]
            logical = (None,) * (nd - 4) + ("batch", "heads", None, None)
            return _dims_spec(tuple(x.shape), logical, mesh, rules)
        if path == "conv":                       # [L(,m), b, k-1, convdim]
            logical = (None,) * (nd - 3) + ("batch", None, "ff")
            return _dims_spec(tuple(x.shape), logical, mesh, rules)
        return P(*([None] * nd))

    return {k: leaf_spec(k, v) for k, v in cache.items()}


def token_pspec(batch: int, mesh: Mesh) -> P:
    return _dims_spec((batch,), ("batch",), mesh, decode_rules())
