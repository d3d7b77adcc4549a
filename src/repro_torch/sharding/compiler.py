"""TeAAL mapping -> PartitionSpec compiler (the reference's
``sharding/compiler.py``).

This is the bridge that makes the paper's mapping language describe the
LM fleet's sharding: a TeAAL ``spacetime`` spec schedules loop ranks in
*space*; on a mesh the spatial axes are the mesh axes (pod, data,
model).  ``compile_mapping`` turns a mapped Einsum into per-tensor
PartitionSpecs:

  * a rank whose partitioned *upper* level is scheduled in space is
    sharded on the mesh axis bound to that spatial rank;
  * ranks scheduled only in time stay local (sequential on-device).

``mapping_spec_for_step`` writes down the production mapping of one
transformer FFN/attention step as a TeAAL cascade, so the same language
describes both the sparse-accelerator models and the LM fleet sharding.
It runs over the port's own ``core/mapping`` and ``core/spec``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

from repro_torch.core.mapping import MappingResolver
from repro_torch.core.spec import AcceleratorSpec, load_spec

from .logical import PartitionSpec as P

AxisBinding = Dict[str, Union[str, Tuple[str, ...]]]


def compile_mapping(spec: AcceleratorSpec, out_name: str,
                    axis_binding: AxisBinding,
                    params: Optional[Dict[str, int]] = None
                    ) -> Dict[str, P]:
    """PartitionSpec per tensor of one mapped Einsum.

    ``axis_binding`` maps spatial rank names (e.g. 'B1', 'F1') to mesh
    axis names.  Every spatial rank must be bound; temporal ranks are
    ignored (local).
    """
    resolver = MappingResolver(spec, params)
    plan = resolver.plan(out_name)
    space = set(plan.space_ranks)
    unbound = space - set(axis_binding)
    if unbound:
        raise ValueError(f"spatial ranks {sorted(unbound)} have no mesh "
                         f"axis binding")

    decl = spec.einsum.declaration
    out: Dict[str, P] = {}
    for t in plan.tensors:
        declared = spec.mapping.rank_order.get(t) or decl[t]
        parts = []
        for r in declared:
            axis = None
            for sr in plan.space_ranks:
                # spatial rank 'B1' shards declared rank 'B'
                if sr.rstrip("0123456789") == r:
                    axis = axis_binding[sr]
                    break
            parts.append(axis)
        out[t] = P(*parts)
    return out


def mapping_spec_for_step(dp: int = 16, tp: int = 16,
                          pods: int = 1) -> AcceleratorSpec:
    """The production LM-step mapping as a TeAAL cascade.

    Two mapped Einsums stand in for the step's two matmul classes:
      H[b, f] = X[b, d] * Wi[d, f]     (up-projection: activations x W1)
      Y[b, d] = H[b, f] * Wo[f, d]     (down-projection)

    B is partitioned across (pod x data) and scheduled in space; F
    across model.  D (the contraction of the first Einsum / output of
    the second) stays temporal -- its reduction is the all-reduce a
    sharded step would run, the collective the roofline's third term
    measures.
    """
    return load_spec({
        "name": "lm-step-mapping",
        "einsum": {
            "declaration": {
                "X": ["B", "D"], "Wi": ["D", "F"], "H": ["B", "F"],
                "Wo": ["F", "D"], "Y": ["B", "D"],
            },
            "expressions": [
                "H[b, f] = X[b, d] * Wi[d, f]",
                "Y[b, d] = H[b, f] * Wo[f, d]",
            ],
        },
        "mapping": {
            "rank-order": {"X": ["B", "D"], "Wi": ["D", "F"],
                           "H": ["B", "F"], "Wo": ["F", "D"],
                           "Y": ["B", "D"]},
            "partitioning": {
                "H": {"B": ["uniform_shape(B0S)"],
                      "F": ["uniform_shape(F0S)"]},
                "Y": {"B": ["uniform_shape(B0S)"],
                      "F": ["uniform_shape(F0S)"]},
            },
            "loop-order": {
                "H": ["B1", "F1", "B0", "F0", "D"],
                "Y": ["B1", "F1", "B0", "D", "F0"],
            },
            "spacetime": {
                "H": {"space": ["B1", "F1"], "time": ["B0", "F0", "D"]},
                "Y": {"space": ["B1", "F1"], "time": ["B0", "D", "F0"]},
            },
        },
    })


def step_partition_specs(global_batch: int, d_model: int, d_ff: int,
                         dp: int = 16, tp: int = 16, pods: int = 1
                         ) -> Dict[str, P]:
    """Compile the production step mapping for concrete sizes."""
    spec = mapping_spec_for_step(dp, tp, pods)
    binding: AxisBinding = {
        "B1": ("pod", "data") if pods > 1 else "data",
        "F1": "model",
    }
    params = {"B0S": max(1, global_batch // (dp * pods)),
              "F0S": max(1, d_ff // tp)}
    return compile_mapping(spec, "H", binding, params)
