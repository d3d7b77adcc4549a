"""Logical axis names -> mesh axes, with divisibility-aware fallback
(the reference's ``sharding/logical.py``).

A tensor dimension is named by a *logical* axis (``("batch", "seq",
"ff")``); the active rule set maps each name to one or more mesh axes.
A mapping is applied only when the dimension is divisible by the
mesh-axis product, so e.g. granite's single KV head stays replicated
instead of failing to shard over the 16-way model axis.

The port runs a step on one device.  ``constrain`` is the identity with
no mesh or a one-device mesh and raises on a mesh of more devices; the
model code calls it nowhere (``models/layers.py``).  The specs
themselves (``spec_for``, ``launch/sharding.py``) are computed for any
mesh, abstract ones included.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch

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


def constrain(x: torch.Tensor,
              logical: Sequence[Optional[str]]) -> torch.Tensor:
    """``x`` itself under no mesh or a one-device mesh.  A mesh of more
    devices raises: the port has no multi-device execution, and a
    constraint it could not keep must not pass silently."""
    mesh = current_mesh()
    if mesh is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"logical axes {logical} vs shape {tuple(x.shape)}")
    n = 1
    for s in mesh.shape.values():
        n *= s
    if n > 1:
        raise NotImplementedError(
            f"constrain on a mesh of {n} devices ({dict(mesh.shape)}): the "
            f"port runs a step on one device")
    return x
