"""The ``meta`` route of the model kernels' wrappers.

Given tensors on the ``meta`` device (shapes and dtypes, no storage), a
wrapper (``flash_attention``, ``flash_attention_bwd``, ``ssd_chunk``,
``ssd_chunk_bwd``, ``block_sparse_matmul``) launches nothing and runs no
plain version: it returns empty outputs of the kernel's shapes and
dtypes and reports the call's operations and bytes, counted by its
module's ``flops`` and ``nbytes``, to every counter that ``counting``
has made active (``launch/cost_analysis.StepCost``).  A dry run walks a
step this way.  The ``cpu`` and ``cuda`` routes do not come here.

On a walked mesh (``launch/mesh.walked_mesh``) the wrapper is given
DTensors.  It then runs its meta route under DTensor's ``local_map``
(``local``), on each rank's shards laid out by the sharding layer's
rules (``sharding/logical.placements_of``: the batch over ``pod`` and
``data``, the heads over ``model``), so that the count it reports is
one device's.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Sequence

from torch.distributed.tensor import Placement
from torch.distributed.tensor.experimental import local_map

#: the counters a meta call reports to; a list shared by every thread,
#: so that a backward run on autograd's worker threads reports too
_ACTIVE: List = []


def record(kernel: str, flops: int, nbytes: int) -> None:
    """One meta call of ``kernel``: ``flops`` operations and ``nbytes``
    bytes, added to each active counter's ``add_kernel``."""
    for counter in _ACTIVE:
        counter.add_kernel(kernel, flops, nbytes)


@contextlib.contextmanager
def counting(counter) -> Iterator:
    """Report the meta calls made inside the block to ``counter``."""
    _ACTIVE.append(counter)
    try:
        yield counter
    finally:
        _ACTIVE.remove(counter)


def local(fn: Callable, args: Sequence, in_places: Sequence,
          out_places) -> object:
    """``fn`` on each rank's local shards of the DTensors ``args``,
    redistributed first to ``in_places`` (DTensor's ``local_map``); its
    outputs are DTensors of ``out_places``."""
    def one(p):            # one tensor's placements: a list, not a tuple
        return None if p is None else list(p)
    if out_places and isinstance(out_places[0], Placement):
        out_places = one(out_places)
    else:
        out_places = tuple(one(p) for p in out_places)
    return local_map(fn, out_placements=out_places,
                     in_placements=tuple(one(p) for p in in_places),
                     redistribute_inputs=True,
                     device_mesh=args[0].device_mesh)(*args)

