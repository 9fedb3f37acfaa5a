"""Single-view depth over a (data, tile, disp) mesh: Deep3D right-view
synthesis, then classical matching (port of
``stereo_tpu/parallel/synthesis.py``).

The JAX engine runs Deep3D partitioned by GSPMD (batch over ``data`` x
``disp``, rows over ``tile``), then the exact single-frame matcher per
frame on each batch shard (``shard_map`` + ``lax.map``).  The port places
the work the same way by hand, as ``parallel.dnn`` does for the stereo
networks:

* the batch splits over the ``data`` x ``disp`` groups, as in JAX;
* each group's frames are resized to Deep3D's full and down shapes on the
  group's first device, and run as one batch split by rows over the
  group's ``tile`` devices: every shard runs Deep3D on its rows in a
  thread of its own (``parallel.rows``), its row-mixing layers exchanging
  halo rows with the neighbouring shards, and the levels below the first
  pool that would not pool a shard's rows whole on the gathered frame
  (``models/deep3d.py``, ``ops.rows``); each shard then blends its own
  rows (one ``upsample_blend`` for its batch, ``synthesis.split_blend``);
* the synthesized rows are joined and resized to the output shape, and the
  classical matcher runs per frame on the device the frame is dealt to
  (:func:`~stereo_tpu_torch.parallel.dnn.frame_devices`).

The rows are split wherever JAX's GSPMD splits them: when ``tile > 1``,
``tile`` divides Deep3D's down height (a shard then holds any whole
number of down rows, one included) and its full view is 4 times the down
view (the blend's view is then exactly the volume's scale on each
shard).  Where the down rows do not divide over ``tile`` (JAX's jit
refuses that sharding), frames are dealt instead: whole frames
round-robin over a group's ``tile`` devices, each running Deep3D and then
the matcher.  :attr:`ShardedSingleViewEngine.row_split` says which was
taken.  When every device of the mesh is one card, the split synthesis
is replayed from a CUDA graph (``ShardThreads.replay``).  On the card the
path launches ``upsample_blend`` on every shard, and ``matching_core`` and
``sampled_window`` per frame.

On a mesh that spans processes every rank calls with the same global
batch, holds replicas on its own devices only and runs its shards of each
``tile`` group (split) or the frames dealt to it; the disparities and
right views are gathered to every rank (``parallel.dnn.gather_frames``).
A group may span processes, as GSPMD splits rows across hosts: each rank
resizes the group's whole frames itself (every rank has the global
batch), runs its shards' rows, and the halo exchanges cross ranks
(``ops/rows.py``); the synthesized rows of such groups are then
all-gathered, so that the rank each frame is dealt to
(:func:`~stereo_tpu_torch.parallel.dnn.frame_slots`) joins them and runs
the classical matcher on the whole frame.  A split across processes runs
eagerly; one within a process is replayed where :attr:`graph_splits`
holds, as in ``parallel.dnn``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..core.config import MatchingConfig, MeshConfig
from . import rows
from .dnn import (frame_slots, frames_of, gather_frames, gather_pieces,
                  split_devices, split_kinds)
from .mesh import Mesh, make_mesh, same_device


class ShardedSingleViewEngine:
    """Batched single-view depth (left views only -> disparities) over a
    (data, tile, disp) mesh (default: the first ``mesh_config.num_devices``
    cards).  ``process_batch`` expects the batch divisible by
    :attr:`batch_group` (= data x disp) and the image height divisible by
    ``tile``.  ``synthesis``: a built ``RightViewSynthesis`` whose weights
    every device copies; else the committed checkpoint is loaded once.

    :attr:`row_split` says whether Deep3D is split by rows over ``tile``
    (else frames are dealt whole; set it False to deal them), and
    :attr:`halo` what the last split exchanged (``parallel.rows.exchanged``:
    ``rounds`` per forward, ``bytes`` over all groups, and of those the
    ``cross_rounds`` and ``cross_bytes`` received from other processes).
    :attr:`graph_splits` says whether a split synthesis within one
    process is replayed from a CUDA graph (every device of the mesh one
    card); set it False to run it eagerly."""

    def __init__(self, matching_config: MatchingConfig,
                 mesh_config: MeshConfig, *, mesh: Optional[Mesh] = None,
                 synthesis=None, checkpoint_dir: Optional[str] = None,
                 compute_dtype: str = "float32"):
        self.config = matching_config
        self.mesh = mesh if mesh is not None else make_mesh(mesh_config)
        self.batch_group = mesh_config.data * mesh_config.disp
        self._tile = mesh_config.tile
        out_shape = (matching_config.height, matching_config.width)
        if out_shape[0] % max(self._tile, 1):
            raise ValueError(f"image height {out_shape[0]} not divisible "
                             f"by the tile mesh extent {self._tile}")
        devices = self.mesh.distinct_devices()
        if synthesis is None:
            from ..synthesis.right_view_synthesis import RightViewSynthesis
            synthesis = RightViewSynthesis(
                output_shape=out_shape, checkpoint_dir=checkpoint_dir,
                compute_dtype=compute_dtype,
                device=devices[0] if devices else self.mesh.first_device)
        self.synthesis = synthesis
        self.replicas = {dev: synthesis if same_device(synthesis.device, dev)
                         else synthesis.to(dev) for dev in devices}
        (fh, fw), (dh, dw) = (synthesis.model_full_shape,
                              synthesis.model_down_shape)
        self.row_split = (self._tile > 1 and dh % self._tile == 0
                          and (fh, fw) == (4 * dh, 4 * dw))
        self._lines = (self.mesh.tile_lines() if self.row_split
                       else [None] * self.batch_group)
        self.halo = None
        self.graph_splits = len(devices) == 1 and devices[0].type == "cuda"
        self._shard_threads = rows.ShardThreads()

    @property
    def graphs_captured(self) -> int:
        return self._shard_threads.graphs_captured

    def _frame(self, device, left: torch.Tensor):
        from ..matching.classical import compute_disparity_map

        left = left.to(device, torch.float32)
        right = self.replicas[device].process_batch(left[None])[0]
        return compute_disparity_map(left, right, self.config), right

    def process_batch(self, left_batch, return_right: bool = False):
        """(N, 3, H, W) 0..255 left views -> (N, H, W) float32 disparities
        (and the synthesized right views when ``return_right``) on the
        mesh's first device.  N must be a multiple of :attr:`batch_group`."""
        from ..matching.classical import compute_disparity_map

        left = torch.as_tensor(left_batch)
        n = left.shape[0]
        if n % self.batch_group:
            raise ValueError(f"batch {n} not divisible by the "
                             f"data x disp mesh extent {self.batch_group}")
        mesh = self.mesh
        slots = frame_slots(mesh, n)
        frames = [None] * n
        with torch.no_grad():
            if self.row_split:
                mine = [i for i, s in enumerate(slots) if mesh.is_local(s)]
                rights = self._synthesize_split(left, mine)
                for i, r in zip(mine, rights):
                    dev = mesh.devices[slots[i]]
                    frames[i] = (compute_disparity_map(
                        left[i].to(dev, torch.float32), r.to(dev),
                        self.config), r)
            else:
                for i, (s, l) in enumerate(zip(slots, left)):
                    if mesh.is_local(s):
                        frames[i] = self._frame(mesh.devices[s], l)
        disparity = gather_frames(mesh, [f and f[0] for f in frames], slots)
        if not return_right:
            return disparity
        return disparity, gather_frames(mesh, [f and f[1] for f in frames],
                                        slots)

    def _synthesize_split(self, left: torch.Tensor, mine: list) -> list:
        """The right views (3, *output shape) of frames ``mine`` of the
        (N, 3, H, W) 0..255 batch (the frames dealt to this process), on
        the mesh's first device: each group's frames split by rows over
        its ``tile`` devices.  A group within this process runs as one
        program, replayed from a CUDA graph when :attr:`graph_splits`; the
        groups that span processes run eagerly, together, and their rows
        are all-gathered (every rank calls this)."""
        mesh, tile = self.mesh, self._tile
        per_group = left.shape[0] // self.batch_group
        devices = split_devices(mesh, range(self.batch_group))
        within, spanning = split_kinds(devices, self._lines)
        rights, halos, wanted = {}, [], set(mine)
        if within:
            right = self._split_rows(
                frames_of((left,), within, per_group)[0],
                [devices[g] for g in within])
            halos.append(self.halo)
            for m, g in enumerate(within):
                for j in range(per_group):
                    rights[g * per_group + j] = right[m * per_group + j]
        crossing = [g for g, line in enumerate(self._lines)
                    if line is not None]
        if crossing:
            pieces = {}
            if spanning:
                results, halo = self._shard_program(
                    [devices[g] for g in spanning],
                    [self._lines[g] for g in spanning],
                    frames_of((left,), spanning, per_group)[0])
                halos.append(halo)
                for g, shards in zip(spanning, results):
                    for t, r in enumerate(shards):
                        if r is not None:
                            pieces[crossing.index(g), t] = r.to(
                                mesh.first_device)
            fh, fw = self.synthesis.model_full_shape
            joined = gather_pieces(mesh, pieces, crossing, tile, torch.empty(
                (per_group, 3, fh // tile, fw), device="meta"))
            for g, shards in zip(crossing, joined):
                held = [j for j in range(per_group)
                        if g * per_group + j in wanted]
                if held:
                    right = self._output(torch.cat(shards, dim=-2)[held])
                    for j, r in zip(held, right):
                        rights[g * per_group + j] = r
        self.halo = rows.merge_halos(halos) if halos else None
        return [rights[i] for i in mine]

    def _split_rows(self, left: torch.Tensor, groups: list) -> torch.Tensor:
        """The right views of the frames dealt in equal runs to ``groups``
        (each a list of ``tile`` devices, all this process's), each run
        split by rows over its group, on the mesh's first device; replayed
        from a CUDA graph when :attr:`graph_splits`."""
        program = functools.partial(self._split_program, groups)
        if not self.graph_splits:
            (right,), self.halo = program(left)
            return right
        left = left.to(self.mesh.first_device, torch.float32)
        (right,), self.halo = self._shard_threads.replay(
            (tuple(map(tuple, groups)), tuple(left.shape)), program, left)
        return right

    def _shard_program(self, groups, lines, left):
        """Each group's frames resized to Deep3D's full and down shapes on
        its first device here, and split by rows over its devices (None: a
        shard of another process, reached through ``lines``): the shards'
        synthesized rows at the full shape, shaped as ``groups`` (None at
        other processes' shards), and what they exchanged."""
        from ..synthesis.right_view_synthesis import (resize_nchw,
                                                      synthesize_rows)

        s = self.synthesis
        per_group = left.shape[0] // len(groups)
        splits = []
        for g, devices in enumerate(groups):
            # The resizes of synthesize_net_batch, on the whole frames.
            home = next(d for d in devices if d is not None)
            lg = left[g * per_group:(g + 1) * per_group].to(home,
                                                           torch.float32)
            views = [resize_nchw(lg, shape) / 255.0
                     for shape in (s.model_full_shape, s.model_down_shape)]
            per = [v.shape[-2] // self._tile for v in views]
            splits.append([None if dev is None else (dev, functools.partial(
                synthesize_rows, self.replicas[dev].model,
                *(v[..., t * p:(t + 1) * p, :].to(dev)
                  for v, p in zip(views, per)), s.compute_dtype))
                for t, dev in enumerate(devices)])
        results, exchanges = self._shard_threads.run(splits, lines)
        return results, rows.exchanged(exchanges)

    def _split_program(self, groups, left):
        results, halo = self._shard_program(groups, None, left)
        first = self.mesh.first_device
        right = torch.cat([torch.cat([r.to(devices[0]) for r in shards],
                                     dim=-2).to(first)
                           for devices, shards in zip(groups, results)])
        return (self._output(right),), halo

    def _output(self, right: torch.Tensor) -> torch.Tensor:
        """Synthesized views at Deep3D's full shape -> the output shape."""
        from ..synthesis.right_view_synthesis import resize_nchw

        return resize_nchw(right, (self.config.height, self.config.width))

    def warmup(self) -> None:
        x = torch.zeros((self.batch_group, 3, self.config.height,
                         self.config.width))
        self.process_batch(x)
