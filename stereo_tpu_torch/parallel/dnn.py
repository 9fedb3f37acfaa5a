"""The stereo networks over a (data, tile, disp) mesh
(port of ``stereo_tpu/parallel/dnn.py``).

The JAX engine annotates batch and row shardings at the jit boundary
(``P(("data", "disp"), None, "tile", None)``) and lets XLA's SPMD
partitioner split every convolution by rows, inserting the halo exchanges
itself.  The port places the work the same way by hand:

* the batch splits over ``data`` x ``disp`` (the batch group), as in JAX;
* each group's frames run as one batch, split by rows over that group's
  ``tile`` devices: every shard runs the single-device network (``eval()``:
  the kernels on the card) on its rows, in a thread of its own, and the
  networks' row-mixing layers exchange halo rows with the neighbouring
  shards (``ops.rows``, the threads in ``parallel.rows``);
* the shards' rows and the groups' frames are joined on the mesh's first
  device.

When every device of the mesh is one card (a virtual mesh), a split is
replayed from a CUDA graph (``parallel.rows.ShardThreads.replay``, one per
layout and batch shape): each shard's launches come from one thread at a
time, and eagerly they would bound the split.  A mesh of distinct cards
keeps the eager shard threads (:attr:`ShardedDnnEngine.graph_splits`).

The rows are split when ``tile > 1`` and the height is a multiple of
``ROW_STRIDE * tile``: the networks' strides multiply to 16, so every shard
then holds at least one row at 1/16 and four at 1/4, enough for each halo.
Other heights that JAX accepts (a multiple of ``tile``) keep the frame
placement of :func:`frame_devices`, whole frames dealt round-robin over a
group's ``tile`` devices; :attr:`ShardedDnnEngine.row_split` says which
was taken.  Both give the single device's result up to float rounding.
Each distinct device of the mesh holds one replica of the weights, loaded
once and copied to the others.

On a mesh that spans processes every rank calls with the same global
batch and builds replicas on its own devices only; it runs the frames
:func:`frame_slots` deals to them (or the groups whose ``tile`` devices
are its own), and every rank receives the whole batch of maps on its
first device through an all-gather (``parallel.transport``).  A row split
whose ``tile`` group spans processes would need the per-layer halo
exchange (``ops/rows.py``) across processes, which is not ported: the
engine refuses such a mesh.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..core.config import MeshConfig
from . import rows
from .mesh import Mesh, make_mesh

# The product of the strides of GwcNet, MSNet2D and MSNet3D: two in the
# feature extractors (1/4), two in each hourglass (1/16).
ROW_STRIDE = 16


def frame_slots(mesh: Mesh, n: int) -> list:
    """The mesh index of each frame of an n-frame batch: the batch splits
    into the ``data`` x ``disp`` groups (data major), and a group's frames
    are dealt round-robin over its ``tile`` devices."""
    data, tile, disp = mesh.shape
    per_group = n // (data * disp)
    slots = []
    for i in range(n):
        group, j = divmod(i, per_group)
        d, p = divmod(group, disp)
        slots.append((d, j % tile, p))
    return slots


def frame_devices(mesh: Mesh, n: int) -> list:
    """The device of each frame of an n-frame batch (:func:`frame_slots`)."""
    return [mesh.devices[s] for s in frame_slots(mesh, n)]


def refuse_split_across_processes(mesh: Mesh) -> None:
    """Raise ``ValueError`` when a ``tile`` group of ``mesh`` spans
    processes: its row split would exchange halo rows between processes
    at every layer, which is not ported."""
    data, tile, disp = mesh.shape
    spanning = [(d, p) for d in range(data) for p in range(disp)
                if mesh.spans([(d, t, p) for t in range(tile)])]
    if spanning:
        raise ValueError(
            f"mesh {mesh.shape} with ranks {mesh.processes.tolist()}: the "
            f"row split's tile groups (data, disp) {spanning} span "
            f"processes, and the split's per-layer halo exchange does not "
            f"cross processes; keep each tile group on one process (data "
            f"across processes, tile within)")


def gather_frames(mesh: Mesh, frames: list, slots: list) -> torch.Tensor:
    """(N, ...) on the mesh's first device from per-frame results:
    ``frames[i]`` computed at mesh index ``slots[i]`` (None on the
    processes that do not hold it)."""
    first = mesh.first_device
    if mesh.processes is None:
        return torch.stack([f.to(first) for f in frames])
    return torch.stack(mesh.transport.all_gather_parts(
        frames, [int(mesh.processes[s]) for s in slots], first))


class ShardedDnnEngine:
    """Batched DNN stereo inference over a (data, tile, disp) mesh
    (default: the first ``mesh_config.num_devices`` cards).
    ``process_batch`` expects the batch divisible by :attr:`batch_group`
    (= data x disp) and the image height divisible by ``tile``.
    :attr:`row_split` says whether frames are split by rows over ``tile``
    (else dealt whole), and :attr:`halo` what the last row-split call
    exchanged: ``rounds`` (halo exchanges per forward) and ``bytes`` (read
    from neighbouring shards, over all groups), recorded at capture for a
    replay.  :attr:`graph_splits` says whether a split is replayed from a
    CUDA graph (every device of the mesh one card); set it False to run
    the split eagerly.  ``graphs_captured`` counts the graphs."""

    def __init__(self, model_name: str, image_shape: Tuple[int, int],
                 mesh_config: MeshConfig, *, mesh: Optional[Mesh] = None,
                 max_disparity: int = 192, state_dict=None,
                 checkpoint_dir: Optional[str] = None,
                 compute_dtype: str = "float32"):
        from ..pipeline.backends import DnnStereoMatchingBackend

        self.model_name = model_name
        self.image_shape = tuple(image_shape)
        self.mesh = mesh if mesh is not None else make_mesh(mesh_config)
        self.batch_group = mesh_config.data * mesh_config.disp
        self._tile = mesh_config.tile
        if image_shape[0] % max(self._tile, 1):
            raise ValueError(f"image height {image_shape[0]} not divisible "
                             f"by the tile mesh extent {self._tile}")
        self.row_split = (self._tile > 1
                          and image_shape[0] % (ROW_STRIDE * self._tile) == 0)
        if self.row_split:
            refuse_split_across_processes(self.mesh)
        self.halo = None
        self._shard_threads = rows.ShardThreads()
        devices = self.mesh.distinct_devices()
        self.graph_splits = len(devices) == 1 and devices[0].type == "cuda"
        backend = DnnStereoMatchingBackend(
            model_name, image_shape, max_disparity=max_disparity,
            state_dict=state_dict, checkpoint_dir=checkpoint_dir,
            compute_dtype=compute_dtype,
            device=devices[0] if devices else self.mesh.first_device)
        self.weights = backend.weights
        self.replicas = {dev: backend if i == 0 else backend.to(dev)
                         for i, dev in enumerate(devices)}

    def process_batch(self, left_batch, right_batch) -> torch.Tensor:
        """(N, 3, H, W) x2 in 0..255 -> (N, H, W) float32 disparities on
        the mesh's first device.  N must be a multiple of
        :attr:`batch_group`."""
        left = torch.as_tensor(left_batch)
        right = torch.as_tensor(right_batch)
        n = left.shape[0]
        if n % self.batch_group:
            raise ValueError(f"batch {n} not divisible by the "
                             f"data x disp mesh extent {self.batch_group}")
        mesh = self.mesh
        if self.row_split:
            data, _, disp = mesh.shape
            keys = [(d, p) for d in range(data) for p in range(disp)]
            if mesh.processes is None:
                return self._split_rows(left, right, [
                    list(mesh.devices[d, :, p]) for d, p in keys])
            # This process's groups, their frames split by rows over their
            # (local) tile devices; every group's maps gathered.
            per_group = n // len(keys)
            mine = [g for g, (d, p) in enumerate(keys)
                    if mesh.is_local((d, 0, p))]
            idx = [g * per_group + j for g in mine for j in range(per_group)]
            frames = [None] * n
            if mine:
                out = self._split_rows(left[idx], right[idx], [
                    list(mesh.devices[keys[g][0], :, keys[g][1]])
                    for g in mine])
                for k, i in enumerate(idx):
                    frames[i] = out[k]
            slots = [(keys[i // per_group][0], 0, keys[i // per_group][1])
                     for i in range(n)]
            return gather_frames(mesh, frames, slots)
        slots = frame_slots(mesh, n)
        out = [self.replicas[mesh.devices[s]].process(l, r)
               if mesh.is_local(s) else None
               for s, l, r in zip(slots, left, right)]
        return gather_frames(mesh, out, slots)

    def process(self, left_image, right_image) -> torch.Tensor:
        """One (3, H, W) pair -> (H, W): split by rows over the first
        group's ``tile`` devices, or whole on the mesh's first entry (on
        the process that holds it, the map then gathered to every
        process)."""
        mesh = self.mesh
        if not mesh.is_local((0, 0, 0)):
            return gather_frames(mesh, [None], [(0, 0, 0)])[0]
        if not self.row_split:
            out = self.replicas[mesh.devices[0, 0, 0]].process(
                left_image, right_image)
        else:
            out = self._split_rows(torch.as_tensor(left_image)[None],
                                   torch.as_tensor(right_image)[None],
                                   [list(mesh.devices[0, :, 0])])[0]
        if mesh.processes is None:
            return out
        return gather_frames(mesh, [out], [(0, 0, 0)])[0]

    @property
    def graphs_captured(self) -> int:
        return self._shard_threads.graphs_captured

    def _split_rows(self, left, right, groups) -> torch.Tensor:
        """The frames dealt in equal runs to ``groups`` (each a list of
        ``tile`` devices), each run split by rows over its group; replayed
        from a CUDA graph when :attr:`graph_splits`."""
        if not self.graph_splits:
            (out,), self.halo = self._split_program(groups, left, right)
            return out
        first = self.mesh.first_device
        left, right = (x.to(first, torch.float32) for x in (left, right))
        key = (tuple(map(tuple, groups)), tuple(left.shape))
        (out,), self.halo = self._shard_threads.replay(
            key, functools.partial(self._split_program, groups), left, right)
        return out

    def _split_program(self, groups, left, right):
        per_group = left.shape[0] // len(groups)
        rows_per = left.shape[-2] // self._tile
        splits = [[(dev, functools.partial(
            self.replicas[dev].process_batch,
            *(x[g * per_group:(g + 1) * per_group, :,
                t * rows_per:(t + 1) * rows_per] for x in (left, right))))
                   for t, dev in enumerate(devices)]
                  for g, devices in enumerate(groups)]
        results, exchanges = self._shard_threads.run(splits)
        first = self.mesh.first_device
        out = torch.cat([torch.cat([r.to(first) for r in shards], dim=-2)
                         for shards in results])
        return (out,), dict(rounds=exchanges[0].rounds,
                            bytes=sum(e.bytes for e in exchanges))

    def warmup(self) -> None:
        x = torch.zeros((self.batch_group, 3, *self.image_shape))
        self.process_batch(x, x)
