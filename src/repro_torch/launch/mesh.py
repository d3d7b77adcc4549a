"""Multi-host sharding of host-side work (the reference's
``launch/mesh.py``, cut to ``host_shard``: the port builds no device
mesh).

Nothing here touches a device; the rank and world size come from
``torch.distributed`` when a process group is initialised.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, TypeVar

_T = TypeVar("_T")


def _process_rank_and_count() -> Tuple[int, int]:
    """(rank, world size) of the initialised ``torch.distributed``
    process group, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard(items: Sequence[_T], *,
               process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> List[_T]:
    """This host's contiguous shard of ``items`` in a multi-host run.

    Defaults to the rank and world size of the initialised
    ``torch.distributed`` process group, and to 0 and 1 without one;
    pass both explicitly to shard without a process group (e.g. in
    tests, or CPU-only sweep fleets coordinated outside torch).
    Shards are contiguous and cover ``items`` exactly: earlier hosts
    get the extra item when the split is uneven, and a single-process
    run returns the whole list.
    """
    if process_index is None or process_count is None:
        rank, world = _process_rank_and_count()
        if process_count is None:
            process_count = world
        if process_index is None:
            process_index = rank
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index {process_index} outside [0, {process_count})")
    n = len(items)
    base, extra = divmod(n, process_count)
    start = process_index * base + min(process_index, extra)
    stop = start + base + (1 if process_index < extra else 0)
    return list(items[start:stop])
