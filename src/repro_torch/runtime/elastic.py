"""Elastic mesh planning (the reference's ``runtime/elastic.py``, plain
Python): pick the best (pods, dp, tp) grid for the
currently healthy chip count, preserving divisibility constraints.

Policy: keep tp fixed (model-parallel groups are latency-critical and
pinned to neighbouring devices); shrink/grow the data axis to the largest
divisor of the healthy chip count; whole lost pods drop the pod axis.
Rescale is implemented as: checkpoint -> new mesh -> resharded restore
(``repro_torch.checkpoint.restore_resharded``), so the optimizer state survives
bit-exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class ElasticPlan:
    pods: int
    dp: int
    tp: int
    used_chips: int
    idle_chips: int
    global_batch_scale: float      # new_dp*pods / old_dp*old_pods


def plan_mesh(healthy_chips: int, tp: int = 16,
              chips_per_pod: int = 256,
              old_plan: Optional[ElasticPlan] = None) -> ElasticPlan:
    """Largest (pods x dp x tp) grid fitting the healthy chip count."""
    assert healthy_chips >= tp, "cannot keep a tp group alive"
    pods = max(1, healthy_chips // chips_per_pod)
    per_pod = healthy_chips // pods
    dp = per_pod // tp
    # dp must be a power-of-two-ish divisor for batch divisibility; take
    # the largest power of two <= dp
    p2 = 1
    while p2 * 2 <= dp:
        p2 *= 2
    dp = p2
    used = pods * dp * tp
    scale = 1.0
    if old_plan is not None and old_plan.dp * old_plan.pods:
        scale = (dp * pods) / (old_plan.dp * old_plan.pods)
    return ElasticPlan(pods=pods, dp=dp, tp=tp, used_chips=used,
                       idle_chips=healthy_chips - used,
                       global_batch_scale=scale)
