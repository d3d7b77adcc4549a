"""Meshes and multi-host sharding of host-side work (the reference's
``launch/mesh.py``).

A ``Mesh`` is ordered axis names and sizes and the devices it spans, or
none for an abstract mesh, which only computes specs
(``launch/sharding.py``).  ``make_mesh`` spans the local CUDA devices
unless the caller names another device (``device="cpu"``, as the tests
do), and raises when the mesh wants more devices than there are: on one
card only 1 x 1 is real.  ``make_production_mesh`` gives the
reference's 16 x 16 and 2 x 16 x 16 pods as abstract meshes.

``walked_mesh`` gives a mesh of any size that a step can run on, on the
``meta`` device: it initialises torch's ``fake`` process-group backend
with one rank for each mesh point, all in this process, and builds a
``DeviceMesh`` with the reference's axis names over it.  DTensor then
propagates every tensor's sharding over that mesh and issues the
collectives each op needs, which the fake group takes without moving a
byte (``launch/dryrun.py`` counts them).  The group is destroyed when
the block exits, also on error.

Kept as functions, as the reference keeps them: importing this module
touches no device.  ``host_shard``'s rank and world size come from
``torch.distributed`` when a process group is initialised, except the
walked mesh's fake group: during a walk a host is rank 0 of 1.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, \
    TypeVar

import torch

_T = TypeVar("_T")
#: ``active``: the fake process group of a ``walked_mesh`` is initialised
_WALK = threading.local()


@dataclass(frozen=True)
class Mesh:
    """Named axes over devices, in row-major order: ``devices[i]`` is
    the device at the i-th index of the axes' product."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    #: the devices spanned, one per mesh point; None for an abstract mesh
    devices: Optional[Tuple[torch.device, ...]] = None
    #: a walked mesh's ``DeviceMesh`` over a fake process group (its
    #: tensors on ``meta``); None otherwise
    device_mesh: Optional[Any] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"a mesh of {self.size} points over "
                             f"{len(self.devices)} devices")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in the axes' order."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        out = 1
        for s in self.axis_sizes:
            out *= s
        return out

    @property
    def abstract(self) -> bool:
        """Specs only: no devices and no walked ``DeviceMesh``."""
        return self.devices is None and self.device_mesh is None

    @property
    def walked(self) -> bool:
        """A ``walked_mesh``: DTensors on ``meta`` over a fake group."""
        return self.device_mesh is not None


def _local_devices(device) -> List[torch.device]:
    """The devices a mesh may span: the one ``device`` names, or every
    local device of its type (the CUDA devices without one)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.index is not None or dev.type != "cuda":
        return [dev]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "make_mesh spans the CUDA devices by default, and no CUDA "
            "device is available; pass device='cpu' for a one-device CPU "
            "mesh")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(dp: int, tp: int, pods: int = 1, device=None) -> Mesh:
    """A (pod x) data x model mesh over real devices (smoke runs and the
    one-card trainer use 1 x 1).  ``device`` names a device type (its
    local devices in order) or one device; CUDA by default.  Raises when
    dp * tp * pods exceeds the devices there are."""
    if pods > 1:
        names, sizes = ("pod", "data", "model"), (pods, dp, tp)
    else:
        names, sizes = ("data", "model"), (dp, tp)
    if min(sizes) < 1:
        raise ValueError(f"mesh sizes {sizes} must be positive")
    devices = _local_devices(device)
    n = dp * tp * pods
    if n > len(devices):
        raise ValueError(f"a {' x '.join(map(str, sizes))} mesh needs {n} "
                         f"devices; {len(devices)} {devices[0].type} "
                         f"device(s) here (walked_mesh walks a step over "
                         f"a mesh of any size on meta)")
    return Mesh(names, sizes, tuple(devices[:n]))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 chips a pod; 2 pods = 512 chips: abstract meshes,
    for specs (``walked_mesh`` walks a step over them)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def axes_for(sizes: Sequence[int]) -> Tuple[str, ...]:
    """The reference's axis names for a mesh of ``sizes``: (data,
    model), or (pod, data, model)."""
    if len(sizes) == 3:
        return ("pod", "data", "model")
    if len(sizes) == 2:
        return ("data", "model")
    raise ValueError(f"a mesh of sizes {tuple(sizes)}: 2 or 3 axes")


@contextlib.contextmanager
def walked_mesh(sizes: Sequence[int]) -> Iterator[Mesh]:
    """A mesh of ``sizes`` (axes named as ``axes_for``) that a step runs
    on as DTensors on ``meta``: torch's ``fake`` process group of one
    rank a mesh point, initialised here, in this process, and destroyed
    on exit, also on error.

    The ``DeviceMesh``'s device type is ``cuda`` (its tensors stay on
    ``meta``, and no CUDA device is needed), so that a Shard -> Shard
    redistribution is DTensor's all-to-all
    (``_dtensor.shard_dim_alltoall``), as on cards: on a ``cpu`` mesh
    DTensor swaps it for an all-gather and a chunk (Gloo has no
    all-to-all), which the counter would record instead.  Raises if a
    process group is already initialised: the fake group must be the
    default one."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    # registers the ``fake`` backend with torch.distributed
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    sizes = tuple(int(s) for s in sizes)
    names = axes_for(sizes)
    if dist.is_initialized():
        raise RuntimeError("walked_mesh: a process group is already "
                           "initialised")
    n = 1
    for s in sizes:
        n *= s
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=n)
    _WALK.active = True
    try:
        dm = DeviceMesh("cuda", torch.arange(n).reshape(sizes),
                        mesh_dim_names=names)
        yield Mesh(names, sizes, device_mesh=dm)
    finally:
        _WALK.active = False
        dist.destroy_process_group()


def mesh_axis_sizes(mesh) -> dict:
    """Axis name -> size."""
    return dict(mesh.shape)


def n_chips(mesh) -> int:
    out = 1
    for s in mesh_axis_sizes(mesh).values():
        out *= s
    return out


def _process_rank_and_count() -> Tuple[int, int]:
    """(rank, world size) of the initialised ``torch.distributed``
    process group, else (0, 1); (0, 1) too during a ``walked_mesh``,
    whose fake group has no hosts."""
    import torch.distributed as dist
    if getattr(_WALK, "active", False):
        return 0, 1
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
