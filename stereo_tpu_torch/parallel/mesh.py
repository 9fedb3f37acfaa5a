"""Device mesh and the placement of sharded data
(port of ``stereo_tpu/parallel/mesh.py``).

A mesh is a (data, tile, disp) grid of ``torch.device``s, driven by one
process, as JAX's single controller drives its mesh:

* ``data`` — batch / video frames,
* ``tile`` — image scanline tiles (ring halo exchange),
* ``disp`` — disparity-axis shards (cross-shard argmax).

Sharded data is a numpy object array of the mesh's shape holding each
device's tensor.  Work is launched device by device from one thread: on
several cards the launches overlap (they are asynchronous), and copies
between shards go device to device.  A mesh may name one device more than
once — ``["cpu"] * 8`` in the tests, ``[cuda:0] * n`` for a virtual mesh on
one card — and then its shards run in turn on that device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import MeshConfig

MESH_AXES = ("data", "tile", "disp")


class Mesh:
    """A (data, tile, disp) array of devices (``devices``) with
    ``axis_names = MESH_AXES``."""

    axis_names = MESH_AXES

    def __init__(self, devices: np.ndarray):
        if devices.ndim != len(MESH_AXES):
            raise ValueError(f"a mesh is {len(MESH_AXES)}-D, got "
                             f"{devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.devices.shape

    @property
    def first_device(self) -> torch.device:
        """Where gathered results are delivered."""
        return self.devices.flat[0]

    def distinct_devices(self) -> list:
        """Each device of the mesh once, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (``cuda`` names the current card)."""
    def full(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return a == b or full(a) == full(b)


def make_mesh(config: MeshConfig, devices: Optional[Sequence] = None) -> Mesh:
    """A (data, tile, disp) mesh of the first ``config.num_devices`` of
    ``devices`` (default: the visible CUDA devices, ``cuda:0..n-1``).
    Raises ``RuntimeError`` when there are fewer.  A list may repeat a
    device; the default never does, and nothing falls back to the CPU."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = config.num_devices
    if len(devices) < n:
        raise RuntimeError(
            f"MeshConfig wants {n} devices but only {len(devices)} present.")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(config.data, config.tile, config.disp))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (the counterpart of ``jax.distributed``): a
    no-op without an address, so launchers may call it unconditionally;
    else ``torch.distributed.init_process_group`` at ``tcp://ADDRESS``
    (NCCL with CUDA, else gloo) with the given world size and rank."""
    if coordinator_address is None:
        return
    import torch.distributed as dist

    address = coordinator_address
    if "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo", init_method=address,
        world_size=num_processes, rank=process_id)


@dataclass(frozen=True)
class Placement:
    """How a tensor lies on a mesh: ``spec[i]`` names the mesh axis (or a
    tuple of axes, major first) that splits tensor axis ``i``, or None;
    the mesh axes it does not name hold copies."""

    mesh: Mesh
    spec: Tuple

    def shard(self, x: torch.Tensor) -> np.ndarray:
        """``x`` -> each device's part, in an array of the mesh's shape."""
        out = np.empty(self.mesh.shape, dtype=object)
        for index in np.ndindex(*self.mesh.shape):
            part = x
            for axis, names in enumerate(self.spec):
                count, pos = _split_of(names, index, self.mesh.shape)
                size = x.shape[axis] // count
                part = part.narrow(axis, pos * size, size)
            out[index] = part.to(self.mesh.devices[index]).contiguous()
        return out

    def gather(self, shards: np.ndarray) -> torch.Tensor:
        """Each device's part -> the whole tensor on the mesh's first
        device (a copy along the axes the spec does not name is read from
        index 0)."""
        def join(index, axis):
            if axis == len(self.spec):
                return shards[tuple(index)].to(self.mesh.first_device)
            mesh_axes = [MESH_AXES.index(n) for n in _names(self.spec[axis])]
            parts = []
            for combo in np.ndindex(*[self.mesh.shape[a] for a in mesh_axes]):
                sub = list(index)
                for a, v in zip(mesh_axes, combo):
                    sub[a] = v
                parts.append(join(sub, axis + 1))
            return torch.cat(parts, dim=axis) if len(parts) > 1 else parts[0]

        return join([0] * len(MESH_AXES), 0)


def _names(entry) -> Tuple[str, ...]:
    """A spec entry (None, an axis name or a tuple of them) as a tuple."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _split_of(entry, index, shape) -> Tuple[int, int]:
    """(number of parts, this device's part) of a tensor axis split by the
    mesh axes of spec entry ``entry``."""
    count, pos = 1, 0
    for name in _names(entry):
        a = MESH_AXES.index(name)
        count, pos = count * shape[a], pos * shape[a] + index[a]
    return count, pos


def batch_sharding(mesh: Mesh) -> Placement:
    """(N, ...) frame batches split over the data axis."""
    return Placement(mesh, ("data",))


def image_row_sharding(mesh: Mesh) -> Placement:
    """(C, H, W) images split by scanline tiles."""
    return Placement(mesh, (None, "tile", None))


def replicated(mesh: Mesh) -> Placement:
    """A copy on every device."""
    return Placement(mesh, ())
