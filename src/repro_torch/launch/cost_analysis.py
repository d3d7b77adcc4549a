"""One step's operations, bytes and collectives, counted as it runs: the
port's counterpart of the reference's ``launch/hlo_analysis.py``.

The reference compiles a step with XLA and reads the compiled module:
``cost_analysis()`` (FLOPs, "bytes accessed"), ``memory_analysis()``
(argument bytes) and the collectives in its HLO text.  The port compiles
nothing, so ``StepCost`` watches the step run instead: a
``TorchDispatchMode`` that sees every aten op the step dispatches -- on
the ``meta`` device (nothing allocated, nothing run: a dry run), or on a
real one -- and counts

  * **operations**: ``torch.utils.flop_counter``'s formulas for aten's
    products (mm, addmm, bmm, baddbmm, convolutions, SDPA; the
    composite ops that reach the mode decomposed first, as
    ``FlopCounterMode`` does), with one repair: torch's formula for a
    grouped convolution's weight gradient multiplies every input channel
    with every output channel, ``groups`` times the work (a depthwise
    conv's, such as Mamba2's, ``conv_dim`` times), so that term is divided
    by ``groups`` (``_conv_backward_flops``); plus each hand-written
    kernel's own count (its module's ``flops``), which the kernels'
    ``meta`` route reports (``kernels/meta.py``);
  * **bytes**: every aten op's operand and result bytes, with views and
    bare allocations counted as 0 (an in-place op's destination counts
    as read and written), plus each kernel's ``nbytes``.  This is the
    traffic of the unfused eager step, op by op: not XLA's fused
    "bytes accessed", and an upper bound on what an op that finds its
    operands in L2 reads from memory;
  * **argument bytes** (``argument_bytes``): the step's parameters,
    optimizer state, batch or cache, the counterpart of
    ``memory_analysis``'s ``argument_size_in_bytes``;
  * **collectives** (``CollectiveStats``): the reference's per-op wire
    multipliers (``wire_bytes``) over each collective's local result
    and group size.  On a one-device mesh a step runs none and the term
    is 0.

On a walked mesh (``launch/mesh.walked_mesh``) the step's tensors are
DTensors, and the mode sees each op twice: first with the DTensors, at
their global shapes, then, from inside DTensor's dispatch, as the ops a
rank runs on its local shards and the ``_c10d_functional`` collectives
(and DTensor's ``_dtensor.shard_dim_alltoall``) that redistribute them.
The counter hands the first back to DTensor uncounted and counts the
second, so every total is per device.  The ops that DTensor's sharding
propagation runs on fake tensors to learn an output's global shape are
not counted either.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import conv_flop_count, flop_registry

from repro_torch.kernels import meta as _meta
from repro_torch.sharding.logical import is_sharded

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

#: ops that move no data: they allocate, or return an alias of an
#: operand that the schema does not mark as one
_aten = torch.ops.aten
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.new_empty.default,
         _aten.new_empty_strided.default, _aten._unsafe_view.default,
         _aten.lift_fresh.default}
#: the functional collectives DTensor issues -> the reference's op names
#: (an all-gather's and a reduce-scatter's group size is an argument;
#: every one names its group last among its positional arguments)
_COLLECTIVE_OPS = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
}
#: functional-collective ops that move no data (they wait on, or wrap,
#: a collective's result)
_COLLECTIVE_FREE = {"_c10d_functional.wait_tensor",
                    "_c10d_functional._wrap_tensor_autograd"}


def wire_bytes(op: str, result_bytes: float,
               group_size: Optional[int] = None) -> float:
    """Bytes one device puts on the wire for one collective ``op`` whose
    result holds ``result_bytes`` (per device), by ring algorithms:

        all-reduce         2x result bytes  (reduce-scatter + all-gather)
        all-gather         1x result bytes  (each device receives ~result)
        reduce-scatter     gx result bytes  (input = g x output flows)
        all-to-all         1x result bytes
        collective-permute 1x result bytes

    An async ``-start`` form of all-reduce, all-gather or
    collective-permute returns (operand, result): half its bytes are the
    result."""
    base = op.replace("-start", "")
    if base not in _COLLECTIVES:
        raise ValueError(f"not a collective: {op!r}")
    if op.endswith("-start") and base in ("all-reduce", "all-gather",
                                          "collective-permute"):
        result_bytes /= 2.0
    if base == "all-reduce":
        return 2.0 * result_bytes
    if base == "reduce-scatter":
        return float(group_size or 1) * result_bytes
    return float(result_bytes)


@dataclass
class CollectiveStats:
    ops: Dict[str, int] = field(default_factory=dict)
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    total_wire_bytes: float = 0.0

    def add(self, op: str, wire: float) -> None:
        self.ops[op] = self.ops.get(op, 0) + 1
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + wire
        self.total_wire_bytes += wire


def _shape(x) -> list:
    return list(x.shape) if isinstance(x, torch.Tensor) else list(x)


def _conv_backward_flops(args, out) -> int:
    """Operations of ``aten.convolution_backward``: torch's count, its
    weight-gradient term divided by the convolution's groups (a grouped
    convolution pairs each output channel with ``c_in / groups`` input
    channels, as its forward count does)."""
    count = flop_registry[_aten.convolution_backward](
        *args, out_val=out)
    grad_out, x, _, _, _, _, _, transposed, _, groups, mask = args[:11]
    if groups > 1 and mask[1]:
        def t(shape):
            return [shape[1], shape[0]] + shape[2:]
        g_w = _shape(out[1])
        if transposed:
            term = conv_flop_count(t(_shape(grad_out)), t(_shape(x)),
                                   t(g_w))
        else:
            term = conv_flop_count(t(_shape(x)), t(_shape(grad_out)),
                                   t(g_w))
        count -= term - term // groups
    return count


def _group_size(args) -> int:
    """The size of the process group a functional collective names (its
    last string argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def argument_bytes(tree: Any) -> int:
    """Bytes of every tensor in ``tree``: a module's parameters and
    buffers, or nested dicts, lists and tuples of tensors."""
    if isinstance(tree, nn.Module):
        return sum(_tensor_bytes(t) for t in tree.parameters()) + \
            sum(_tensor_bytes(t) for t in tree.buffers())
    leaves, _ = tree_flatten(tree)
    return sum(_tensor_bytes(t) for t in leaves
               if isinstance(t, torch.Tensor))


class StepCost(TorchDispatchMode):
    """Counts the operations and bytes of what runs inside ``with
    StepCost() as cost:``, aten ops and the kernels' meta calls apart:
    ``cost.flops``, ``cost.hbm_bytes``; ``aten_flops`` / ``aten_bytes``
    by op, ``kernel_flops`` / ``kernel_bytes`` / ``kernel_calls`` by
    kernel; ``collectives`` (none on one device).  On a walked mesh
    every count is one device's."""

    def __init__(self):
        super().__init__()
        self.aten_flops: Counter = Counter()
        self.aten_bytes: Counter = Counter()
        self.kernel_flops: Counter = Counter()
        self.kernel_bytes: Counter = Counter()
        self.kernel_calls: Counter = Counter()
        self.collectives = CollectiveStats()
        self._depth = 0          # the mode re-enters itself to decompose

    @property
    def flops(self) -> int:
        return sum(self.aten_flops.values()) + \
            sum(self.kernel_flops.values())

    @property
    def hbm_bytes(self) -> int:
        return sum(self.aten_bytes.values()) + \
            sum(self.kernel_bytes.values())

    def add_kernel(self, kernel: str, flops: int, nbytes: int) -> None:
        """One hand-written kernel's call (``kernels/meta.record``)."""
        self.kernel_flops[kernel] += flops
        self.kernel_bytes[kernel] += nbytes
        self.kernel_calls[kernel] += 1

    def __enter__(self):
        if self._depth == 0:
            self._counting = _meta.counting(self)
            self._counting.__enter__()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                self._counting.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        operands, _ = tree_flatten((args, kwargs))
        if any(is_sharded(t) for t in operands):
            # DTensor's own dispatch runs the local ops and collectives,
            # which come back here
            return NotImplemented
        if any(_is_fake(t) for t in operands):
            return func(*args, **kwargs)    # sharding propagation
        packet = func._overloadpacket
        name = str(packet)
        if name in _COLLECTIVE_FREE:
            return func(*args, **kwargs)
        if name in _COLLECTIVE_OPS or name.startswith("_c10d_functional."):
            if name not in _COLLECTIVE_OPS:
                raise NotImplementedError(f"StepCost: collective {name}")
            out = func(*args, **kwargs)
            result = sum(_tensor_bytes(t) for t in tree_flatten(out)[0]
                         if isinstance(t, torch.Tensor))
            self.collectives.add(_COLLECTIVE_OPS[name], wire_bytes(
                _COLLECTIVE_OPS[name], result, _group_size(args)))
            self.aten_bytes[name] += result + sum(
                _tensor_bytes(t) for t in operands
                if isinstance(t, torch.Tensor))
            return out
        if packet not in flop_registry:
            # a composite op counts as what it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if packet is _aten.convolution_backward:
            self.aten_flops[name] += _conv_backward_flops(args, out)
        elif packet in flop_registry:
            self.aten_flops[name] += flop_registry[packet](
                *args, **kwargs, out_val=out)
        if not func.is_view and func not in _FREE:
            results, _ = tree_flatten(out)
            self.aten_bytes[name] += sum(
                _tensor_bytes(t) for t in operands + results
                if isinstance(t, torch.Tensor))
        return out
