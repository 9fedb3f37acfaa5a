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

The rows are split whenever ``tile > 1``, at every height JAX accepts (a
multiple of ``tile``), as GSPMD splits them.  The networks' four strides
(two in the feature extractor, down to 1/4, two in each hourglass, down
to 1/16) each need an even number of rows in a shard, and the dilated
blocks at 1/4 a halo of two rows: where a shard's rows would stop
striding whole, or the 1/4 level would hold fewer rows than that halo,
the shard gathers the whole frame's rows ahead of that stride and runs
the levels below on them, then narrows back to its own rows where they
divide again (``ops.rows.Descent``; the networks' docstrings say where).
The ``gather_rounds`` of :attr:`ShardedDnnEngine.halo` count the gathers
the last call ran: none where 16 divides a shard's rows.  A GwcNet shard
launches ``gwc_volume`` once a call either way, on its own rows where
they split at 1/4, else on the whole frame's.  Dealing whole frames
round-robin over a group's ``tile`` devices (:func:`frame_devices`) stays
as a switch (``row_split = False``).  Both give the single device's
result up to float rounding.  Each distinct device of the mesh holds one
replica of the weights, loaded once and copied to the others.

On a mesh that spans processes every rank calls with the same global
batch and builds replicas on its own devices only; it runs the frames
:func:`frame_slots` deals to them, or its own shards of each ``tile``
group, and every rank receives the whole batch of maps on its first
device through an all-gather (``parallel.transport``).  A ``tile`` group
may span processes, as GSPMD splits rows across hosts: each rank runs its
shards of the group, and the per-layer halo exchange crosses ranks
(``ops/rows.py``, through the group's ``Line``).  Such a split runs
eagerly (gloo's host staging cannot be captured in a CUDA graph); a split
within one rank is still replayed where :attr:`graph_splits` holds.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..core.config import MeshConfig
from . import rows
from .mesh import Mesh, make_mesh



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


def gather_frames(mesh: Mesh, frames: list, slots: list) -> torch.Tensor:
    """(N, ...) on the mesh's first device from per-frame results:
    ``frames[i]`` computed at mesh index ``slots[i]`` (None on the
    processes that do not hold it)."""
    first = mesh.first_device
    if mesh.processes is None:
        return torch.stack([f.to(first) for f in frames])
    return torch.stack(mesh.transport.all_gather_parts(
        frames, [int(mesh.processes[s]) for s in slots], first))


def split_keys(mesh: Mesh) -> list:
    """The (data, disp) pair of each ``tile`` group, data major: the order
    in which a batch's frames are dealt to the groups."""
    data, _, disp = mesh.shape
    return [(d, p) for d in range(data) for p in range(disp)]


def split_devices(mesh: Mesh, groups) -> list:
    """The devices of each ``tile`` group of ``groups`` (indices into
    :func:`split_keys`), None at the shards of other processes."""
    keys = split_keys(mesh)
    return [[mesh.devices[keys[g][0], t, keys[g][1]]
             if mesh.is_local((keys[g][0], t, keys[g][1])) else None
             for t in range(mesh.shape[1])] for g in groups]


def split_kinds(devices: list, lines: list) -> tuple:
    """``(within, spanning)``: the positions of the groups whose shards
    (``devices[k]``, None at another process's shard) are all this
    process's, and of those that span processes (``lines[k]`` not None)
    with a shard here.  Groups with no shard here are in neither."""
    within = [k for k, devs in enumerate(devices)
              if lines[k] is None and None not in devs]
    spanning = [k for k, devs in enumerate(devices)
                if lines[k] is not None and any(d is not None for d in devs)]
    return within, spanning


def frames_of(tensors, positions: list, per_group: int) -> list:
    """Each of ``tensors`` cut to the frames of the groups at
    ``positions`` (each group ``per_group`` consecutive frames)."""
    idx = [k * per_group + j for k in positions for j in range(per_group)]
    return [x if idx == list(range(x.shape[0])) else x[idx]
            for x in tensors]


def gather_pieces(mesh: Mesh, pieces: dict, groups: list, tile: int,
                  like: torch.Tensor) -> list:
    """Every shard's rows of the ``tile`` groups ``groups`` (indices into
    :func:`split_keys`) on every process, on its first device:
    ``pieces[k, t]`` is shard t's of group ``groups[k]``, on the process
    that holds it; all have the shape and dtype of ``like``.  Returns
    ``[k][t]``.  Called by every rank."""
    keys = split_keys(mesh)
    owners = [int(mesh.processes[keys[g][0], t, keys[g][1]])
              for g in groups for t in range(tile)]
    parts = mesh.transport.all_gather_parts(
        [pieces.get((k, t)) for k in range(len(groups)) for t in range(tile)],
        owners, mesh.first_device, like=like)
    return [parts[k * tile:(k + 1) * tile] for k in range(len(groups))]


class ShardedDnnEngine:
    """Batched DNN stereo inference over a (data, tile, disp) mesh
    (default: the first ``mesh_config.num_devices`` cards).
    ``process_batch`` expects the batch divisible by :attr:`batch_group`
    (= data x disp) and the image height divisible by ``tile``.
    :attr:`row_split` says whether frames are split by rows over ``tile``:
    true for every ``tile > 1``; set it False to deal whole frames over a
    group's ``tile`` devices instead.  :attr:`halo` says what the last
    row-split call exchanged (``rows.exchanged``): ``rounds`` (halo
    exchanges per forward), of which ``gather_rounds`` gathered the whole
    frame's rows ahead of a stride (module docstring), ``bytes`` (read
    from neighbouring shards, over all groups), and of those
    ``cross_rounds`` and ``cross_bytes`` received from other processes,
    recorded at capture for a replay.  :attr:`graph_splits`
    says whether a split within one process is replayed from a CUDA graph
    (every device of the mesh one card); set it False to run the split
    eagerly.  ``graphs_captured`` counts the graphs."""

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
        self.row_split = self._tile > 1
        self._lines = (self.mesh.tile_lines() if self.row_split
                       else [None] * self.batch_group)
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
            return self._split_groups(left, right, range(self.batch_group))
        slots = frame_slots(mesh, n)
        out = [self.replicas[mesh.devices[s]].process(l, r)
               if mesh.is_local(s) else None
               for s, l, r in zip(slots, left, right)]
        return gather_frames(mesh, out, slots)

    def process(self, left_image, right_image) -> torch.Tensor:
        """One (3, H, W) pair -> (H, W): split by rows over the first
        group's ``tile`` devices (on every process that holds one of
        them), or whole on the mesh's first entry (on the process that
        holds it); on a mesh that spans processes the map is then gathered
        to every process."""
        mesh = self.mesh
        if self.row_split:
            return self._split_groups(torch.as_tensor(left_image)[None],
                                      torch.as_tensor(right_image)[None],
                                      [0])[0]
        if not mesh.is_local((0, 0, 0)):
            return gather_frames(mesh, [None], [(0, 0, 0)])[0]
        out = self.replicas[mesh.devices[0, 0, 0]].process(left_image,
                                                           right_image)
        if mesh.processes is None:
            return out
        return gather_frames(mesh, [out], [(0, 0, 0)])[0]

    @property
    def graphs_captured(self) -> int:
        return self._shard_threads.graphs_captured

    def _split_groups(self, left, right, groups) -> torch.Tensor:
        """The frames dealt in equal runs to the ``tile`` groups
        ``groups`` (indices, data major), each run split by rows over its
        group: (N, H, W) on the mesh's first device.  On a mesh that spans
        processes each rank runs its own shards (a group within it as one
        program, replayed where :attr:`graph_splits` holds; the groups
        that span processes eagerly, together), then every shard's rows
        are all-gathered."""
        mesh, tile, groups = self.mesh, self._tile, list(groups)
        devices = split_devices(mesh, groups)
        if mesh.processes is None:
            return self._split_rows(left, right, devices)
        per_group = left.shape[0] // len(groups)
        rows_per = left.shape[-2] // tile
        within, spanning = split_kinds(devices,
                                       [self._lines[g] for g in groups])
        pieces, halos = {}, []
        if within:
            out = self._split_rows(
                *frames_of((left, right), within, per_group),
                [devices[k] for k in within])
            halos.append(self.halo)
            for m, k in enumerate(within):
                for t in range(tile):
                    pieces[k, t] = out[m * per_group:(m + 1) * per_group,
                                       t * rows_per:(t + 1) * rows_per]
        if spanning:
            results, halo = self._shard_program(
                [devices[k] for k in spanning],
                [self._lines[groups[k]] for k in spanning],
                *frames_of((left, right), spanning, per_group))
            halos.append(halo)
            for m, k in enumerate(spanning):
                for t, r in enumerate(results[m]):
                    if r is not None:
                        pieces[k, t] = r.to(mesh.first_device)
        self.halo = rows.merge_halos(halos) if halos else None
        joined = gather_pieces(mesh, pieces, groups, tile, torch.empty(
            (per_group, rows_per, left.shape[-1]), device="meta"))
        return torch.cat([torch.cat(shards, dim=-2) for shards in joined])

    def _split_rows(self, left, right, groups) -> torch.Tensor:
        """The frames dealt in equal runs to ``groups`` (each a list of
        ``tile`` devices, all this process's), each run split by rows over
        its group; replayed from a CUDA graph when :attr:`graph_splits`."""
        if not self.graph_splits:
            (out,), self.halo = self._split_program(groups, left, right)
            return out
        first = self.mesh.first_device
        left, right = (x.to(first, torch.float32) for x in (left, right))
        key = (tuple(map(tuple, groups)), tuple(left.shape))
        (out,), self.halo = self._shard_threads.replay(
            key, functools.partial(self._split_program, groups), left, right)
        return out

    def _shard_program(self, groups, lines, left, right):
        """Each group's frames split by rows over its devices (None: a
        shard of another process, reached through ``lines``): the shards'
        results, shaped as ``groups`` (None at other processes' shards),
        and what they exchanged."""
        per_group = left.shape[0] // len(groups)
        rows_per = left.shape[-2] // self._tile
        splits = [[None if dev is None else (dev, functools.partial(
            self.replicas[dev].process_batch,
            *(x[g * per_group:(g + 1) * per_group, :,
                t * rows_per:(t + 1) * rows_per] for x in (left, right))))
                   for t, dev in enumerate(devices)]
                  for g, devices in enumerate(groups)]
        results, exchanges = self._shard_threads.run(splits, lines)
        return results, rows.exchanged(exchanges)

    def _split_program(self, groups, left, right):
        results, halo = self._shard_program(groups, None, left, right)
        first = self.mesh.first_device
        out = torch.cat([torch.cat([r.to(first) for r in shards], dim=-2)
                         for shards in results])
        return (out,), halo

    def warmup(self) -> None:
        x = torch.zeros((self.batch_group, 3, *self.image_shape))
        self.process_batch(x, x)
