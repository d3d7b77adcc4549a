"""Logical axis names -> mesh axes, with divisibility-aware fallback
(the reference's ``sharding/logical.py``).

A tensor dimension is named by a *logical* axis (``("batch", "seq",
"ff")``); the active rule set maps each name to one or more mesh axes.
A mapping is applied only when the dimension is divisible by the
mesh-axis product, so e.g. granite's single KV head stays replicated
instead of failing to shard over the 16-way model axis.

``constrain`` is the counterpart of ``with_sharding_constraint``: the
identity with no mesh or a one-device mesh; on a walked mesh
(``launch/mesh.walked_mesh``: DTensors on ``meta`` over a fake process
group) it redistributes a DTensor to its spec's placements
(``placements``), which issues the collectives the change needs; on a
real mesh of more devices it raises, since the port runs a step on one
card.  The models call it where the reference does.  The specs
themselves (``spec_for``, ``launch/sharding.py``) are computed for any
mesh, abstract ones included.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

_STATE = threading.local()


class PartitionSpec(tuple):
    """One entry a dimension: None (replicated), a mesh axis name, or a
    tuple of names (sharded over their product)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass
class AxisRules:
    rules: Dict[str, Tuple[str, ...]] = field(default_factory=dict)

    def axes_for(self, name: Optional[str]) -> Tuple[str, ...]:
        if name is None:
            return ()
        return self.rules.get(name, ())


def default_rules() -> AxisRules:
    """The production mapping: batch over (pod, data); width over model.

    This is the compiled form of the TeAAL ``spacetime`` spec in
    ``repro_torch.sharding.compiler.mapping_spec_for_step`` -- spatial
    ranks bind to mesh axes, temporal ranks stay local.
    """
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
        "kv_seq": ("data",),          # long-context decode: shard the cache
        "state": (),
    })


def set_rules(rules: Optional[AxisRules]) -> None:
    _STATE.rules = rules


def current_rules() -> Optional[AxisRules]:
    """The rules ``set_rules`` set, None when unset."""
    return getattr(_STATE, "rules", None)


def get_rules() -> AxisRules:
    return getattr(_STATE, "rules", None) or default_rules()


def set_mesh(mesh) -> None:
    _STATE.mesh = mesh


def current_mesh():
    return getattr(_STATE, "mesh", None)


def spec_for(shape: Sequence[int],
             logical: Sequence[Optional[str]],
             mesh=None) -> PartitionSpec:
    """PartitionSpec for ``shape`` under the active rules; axes that do
    not divide are dropped (replicated)."""
    mesh = mesh or current_mesh()
    rules = get_rules()
    if mesh is None:
        return P(*([None] * len(logical)))
    sizes = dict(mesh.shape)
    used = set()
    parts = []
    for dim, name in zip(shape, logical):
        axes = [a for a in rules.axes_for(name)
                if a in sizes and a not in used]
        keep = []
        prod = 1
        for a in axes:
            if dim % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        used.update(keep)
        if not keep:
            parts.append(None)
        elif len(keep) == 1:
            parts.append(keep[0])
        else:
            parts.append(tuple(keep))
    return P(*parts)


def placements(spec: PartitionSpec, mesh) -> Tuple:
    """DTensor's placements of ``spec`` on ``mesh``: one a mesh axis, in
    the mesh's order, ``Shard(d)`` for the axis that tensor dim ``d``
    lies over and ``Replicate()`` for the others.

    A dim over several axes (the batch over ``("pod", "data")``) is
    split by them major to minor in the spec's order, as jax splits it;
    DTensor splits a dim by its mesh axes in the mesh's order, so a spec
    whose axes run against the mesh's order raises."""
    names = tuple(mesh.axis_names)
    out: list = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        axes = () if part is None else \
            (part,) if isinstance(part, str) else tuple(part)
        at = [names.index(a) for a in axes]
        if at != sorted(at):
            raise ValueError(f"spec {spec}: dim {dim} over {axes}, against "
                             f"the mesh's order {names}")
        for i in at:
            out[i] = Shard(dim)
    return tuple(out)


def placements_of(shape: Sequence[int],
                  logical: Sequence[Optional[str]]) -> Tuple:
    """The placements on the current mesh of a tensor of ``shape``
    whose dims are named ``logical``, under the active rules."""
    mesh = current_mesh()
    return placements(spec_for(tuple(shape), logical, mesh), mesh)


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor (a step walked over a mesh)."""
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor,
              logical: Sequence[Optional[str]]) -> torch.Tensor:
    """``x`` itself under no mesh or a one-device mesh.  On a walked
    mesh, ``x`` redistributed to the placements of its spec under the
    active rules (a plain tensor there counts as replicated), and its
    gradient with it (``_Constrain``).  A real mesh of more devices
    raises: the port runs a step on one device, and a constraint it
    could not keep must not pass silently."""
    mesh = current_mesh()
    if mesh is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"logical axes {logical} vs shape {tuple(x.shape)}")
    if not getattr(mesh, "walked", False):
        n = 1
        for s in mesh.shape.values():
            n *= s
        if n > 1:
            raise NotImplementedError(
                f"constrain on a mesh of {n} devices ({dict(mesh.shape)}): "
                f"the port runs a step on one device (walked_mesh walks "
                f"one on meta)")
        return x
    want = placements(spec_for(tuple(x.shape), logical, mesh), mesh)
    if not is_sharded(x):
        x = DTensor.from_local(x, mesh.device_mesh,
                               [Replicate()] * len(want), run_check=False)
    return _Constrain.apply(x, mesh.device_mesh, want, want)


def reshard(x: torch.Tensor, logical: Sequence[Optional[str]]
            ) -> torch.Tensor:
    """A DTensor ``x`` on a walked mesh redistributed to its spec's
    placements, and its gradient back to ``x``'s own placements (not to
    the spec's, as ``constrain``'s is): for a reshape whose gradient
    DTensor could only take apart in ``x``'s layout.  Anything else
    (no walked mesh) is returned as it is."""
    if not is_sharded(x):
        return x
    mesh = current_mesh()
    want = placements(spec_for(tuple(x.shape), logical, mesh), mesh)
    return _Constrain.apply(x, mesh.device_mesh, want, tuple(x.placements))


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``want``, and its gradient to
    ``grad_want``.  ``constrain`` takes the two equal, as jax constrains
    the cotangent of ``with_sharding_constraint`` to the same sharding:
    a gradient that arrives as a partial sum is reduced there, also
    where the forward had nothing to move."""

    @staticmethod
    def forward(ctx, x, mesh, want, grad_want):
        ctx.mesh, ctx.want = mesh, grad_want
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.want:
            grad = grad.redistribute(ctx.mesh, ctx.want)
        return grad, None, None, None
