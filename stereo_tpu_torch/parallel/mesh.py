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

Under a default process group of more than one rank (after
``initialize_distributed``) a mesh spans the processes, as JAX's spans
hosts after ``jax.distributed.initialize``: :func:`make_mesh` joins every
rank's local devices in rank order, and :attr:`Mesh.processes` records
the rank of each entry.  Every rank then calls an engine with the same
global batch; each builds and runs only its own entries' parts, and the
shards of other ranks are reached through ``parallel.transport``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import MeshConfig
from . import transport
from .transport import Line, Transport, world_size

MESH_AXES = ("data", "tile", "disp")


class Mesh:
    """A (data, tile, disp) array of devices (``devices``) with
    ``axis_names = MESH_AXES``.

    ``processes``, for a mesh that spans processes, is an int array of the
    mesh's shape holding each entry's rank, and ``local_devices`` this
    process's own list (its first device receives gathered results);
    ``transport`` then moves values between the ranks.  Without them every
    entry is this process's."""

    axis_names = MESH_AXES

    def __init__(self, devices: np.ndarray,
                 processes: Optional[np.ndarray] = None,
                 local_devices: Optional[Sequence[torch.device]] = None):
        if devices.ndim != len(MESH_AXES):
            raise ValueError(f"a mesh is {len(MESH_AXES)}-D, got "
                             f"{devices.shape}")
        self.devices = devices
        self.processes = processes
        self.local_devices = list(local_devices or [])
        self.transport = Transport() if processes is not None else None

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.devices.shape

    @property
    def first_device(self) -> torch.device:
        """Where gathered results are delivered: this process's first
        device."""
        if self.processes is not None:
            return self.local_devices[0]
        return self.devices.flat[0]

    def is_local(self, index) -> bool:
        """Whether entry ``index`` is this process's."""
        return (self.processes is None
                or self.processes[index] == self.transport.rank)

    def spans(self, indices) -> bool:
        """Whether the entries ``indices`` lie on more than one process."""
        return (self.processes is not None
                and len({int(self.processes[i]) for i in indices}) > 1)

    def line(self, indices) -> Optional[Line]:
        """The transport's :class:`~.transport.Line` over the entries
        ``indices`` (a ring or a disp group), or None when one process
        holds them all.  Made at engine construction: its process group is
        made then, on every rank in the same order."""
        if not self.spans(indices):
            return None
        return Line(self.transport, [int(self.processes[i])
                                     for i in indices])

    def tile_lines(self) -> list:
        """The :meth:`line` of each ``tile`` group (one per (data, disp)
        pair, data major): where a row split's shards span processes, the
        line its exchanges cross; None where one process holds the group.
        Made at engine construction, on every rank in the same order."""
        data, tile, disp = self.shape
        return [self.line([(d, t, p) for t in range(tile)])
                for d in range(data) for p in range(disp)]

    def distinct_devices(self) -> list:
        """Each of this process's devices of the mesh once, in mesh
        order."""
        return list(dict.fromkeys(d for i, d in np.ndenumerate(self.devices)
                                  if self.is_local(i)))


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
    device; the default never does, and nothing falls back to the CPU.

    Under a default process group of more than one rank ``devices`` is
    this process's list (the default, its visible cards): the ranks
    exchange their lists and the mesh takes the first n of their
    concatenation in rank order, as ``jax.devices()`` lists every
    process's devices in process order.  Every rank must call it."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = config.num_devices
    owners = None
    if world_size() > 1:
        import torch.distributed as dist

        if not devices:
            raise RuntimeError(f"rank {dist.get_rank()} has no devices for "
                               f"the mesh's results")
        lists = [None] * dist.get_world_size()
        dist.all_gather_object(lists, [str(d) for d in devices])
        local, devices = devices, [torch.device(d) for names in lists
                                   for d in names]
        owners = [r for r, names in enumerate(lists) for _ in names]
    if len(devices) < n:
        raise RuntimeError(
            f"MeshConfig wants {n} devices but only {len(devices)} present.")
    shape = (config.data, config.tile, config.disp)
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    if owners is None:
        return Mesh(grid.reshape(shape))
    return Mesh(grid.reshape(shape),
                np.asarray(owners[:n], dtype=np.int64).reshape(shape), local)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Multi-host bring-up (the counterpart of ``jax.distributed``): a
    no-op without an address, so launchers may call it unconditionally;
    else ``torch.distributed.init_process_group`` at ``tcp://ADDRESS`` (or
    any init-method URL, e.g. ``file://PATH``) with the given world size
    and rank, on ``backend`` (default NCCL with CUDA, else gloo; gloo
    stages CUDA tensors through the host, as two ranks on one card need:
    NCCL refuses them).  The group's timeout is ``transport.TIMEOUT_S``:
    it bounds the rendezvous (a rank that never comes) and every
    collective of the group."""
    if coordinator_address is None:
        return
    import torch.distributed as dist

    address = coordinator_address
    if "://" not in address:
        address = f"tcp://{address}"
    try:
        dist.init_process_group(
            backend or ("nccl" if torch.cuda.is_available() else "gloo"),
            init_method=address, world_size=num_processes, rank=process_id,
            timeout=transport.timeout())
    except RuntimeError as exc:
        raise RuntimeError(
            f"rank {process_id} of {num_processes} joining the group at "
            f"{address} (bound {transport.TIMEOUT_S} s): {exc}") from exc


@dataclass(frozen=True)
class Placement:
    """How a tensor lies on a mesh: ``spec[i]`` names the mesh axis (or a
    tuple of axes, major first) that splits tensor axis ``i``, or None;
    the mesh axes it does not name hold copies."""

    mesh: Mesh
    spec: Tuple

    def shard(self, x: torch.Tensor) -> np.ndarray:
        """``x`` -> each device's part, in an array of the mesh's shape
        (None at the entries of other processes: each builds its own)."""
        out = np.empty(self.mesh.shape, dtype=object)
        for index in np.ndindex(*self.mesh.shape):
            if not self.mesh.is_local(index):
                continue
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
        index 0).  On a mesh that spans processes every rank passes its
        own parts and receives the whole tensor, through an all-gather of
        the parts at index 0 (JAX would leave a global array, which
        ``np.asarray`` cannot read off its host; the port's callers need
        the whole map)."""
        if self.mesh.processes is not None:
            shards = self._all_gather(shards)

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

    def _all_gather(self, shards: np.ndarray) -> np.ndarray:
        """The parts ``gather`` reads (index 0 on the axes the spec does
        not name), every one of them, on this process's first device."""
        named = {MESH_AXES.index(n) for entry in self.spec
                 for n in _names(entry)}
        read = [i for i in np.ndindex(*self.mesh.shape)
                if all(i[a] == 0 for a in range(len(MESH_AXES))
                       if a not in named)]
        mesh = self.mesh
        parts = mesh.transport.all_gather_parts(
            [shards[i] if mesh.is_local(i) else None for i in read],
            [int(mesh.processes[i]) for i in read], mesh.first_device)
        full = np.empty(mesh.shape, dtype=object)
        for i, part in zip(read, parts):
            full[i] = part
        return full


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
