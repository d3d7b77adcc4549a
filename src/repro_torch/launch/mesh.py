"""Meshes and multi-host sharding of host-side work (the reference's
``launch/mesh.py``).

A ``Mesh`` is ordered axis names and sizes and the devices it spans, or
none for an abstract mesh, which only computes specs
(``launch/sharding.py``).  ``make_mesh`` spans the local CUDA devices
unless the caller names another device (``device="cpu"``, as the tests
do), and raises when the mesh wants more devices than there are: on one
card only 1 x 1 is real.  ``make_production_mesh`` gives the
reference's 16 x 16 and 2 x 16 x 16 pods as abstract meshes.

Kept as functions, as the reference keeps them: importing this module
touches no device.  ``host_shard``'s rank and world size come from
``torch.distributed`` when a process group is initialised.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, TypeVar

import torch

_T = TypeVar("_T")


@dataclass(frozen=True)
class Mesh:
    """Named axes over devices, in row-major order: ``devices[i]`` is
    the device at the i-th index of the axes' product."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    #: the devices spanned, one per mesh point; None for an abstract mesh
    devices: Optional[Tuple[torch.device, ...]] = None

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
        return self.devices is None


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
                         f"device(s) here")
    return Mesh(names, sizes, tuple(devices[:n]))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 chips a pod; 2 pods = 512 chips: abstract meshes,
    for specs only (no machine here has their devices)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


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
