"""The ``meta`` route of the model kernels' wrappers.

Given tensors on the ``meta`` device (shapes and dtypes, no storage), a
wrapper (``flash_attention``, ``flash_attention_bwd``, ``ssd_chunk``,
``ssd_chunk_bwd``, ``block_sparse_matmul``) launches nothing and runs no
plain version: it returns empty outputs of the kernel's shapes and
dtypes and reports the call's operations and bytes, counted by its
module's ``flops`` and ``nbytes``, to every counter that ``counting``
has made active (``launch/cost_analysis.StepCost``).  A dry run walks a
step this way.  The ``cpu`` and ``cuda`` routes do not come here.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List

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
