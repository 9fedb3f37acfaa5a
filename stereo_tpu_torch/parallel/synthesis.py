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

The rows are split when ``tile > 1``, Deep3D's down height is a multiple
of ``DEEP3D_ROW_STRIDE * tile`` and its full view is 4 times the down view
(the blend's view is then exactly the volume's scale on each shard).
Other heights that JAX accepts keep the frame placement: whole frames
dealt round-robin over a group's ``tile`` devices, each running Deep3D and
then the matcher.  :attr:`ShardedSingleViewEngine.row_split` says which
was taken.  When every device of the mesh is one card, the split synthesis
is replayed from a CUDA graph (``ShardThreads.replay``).  On the card the
path launches ``upsample_blend`` on every shard, and ``matching_core`` and
``sampled_window`` per frame.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..core.config import MatchingConfig, MeshConfig
from . import rows
from .dnn import frame_devices
from .mesh import Mesh, make_mesh, same_device

# The product of the strides of Deep3D's first three pools (VggBlock_0-2).
# A shard whose down-view rows are a multiple of it pools them whole; the
# gather of the shards' rows then comes at VggBlock_3's pool at the
# earliest, so the levels run whole on every shard are at most 1/8 of the
# down view (12x40 at 96x320).
DEEP3D_ROW_STRIDE = 8


class ShardedSingleViewEngine:
    """Batched single-view depth (left views only -> disparities) over a
    (data, tile, disp) mesh (default: the first ``mesh_config.num_devices``
    cards).  ``process_batch`` expects the batch divisible by
    :attr:`batch_group` (= data x disp) and the image height divisible by
    ``tile``.  ``synthesis``: a built ``RightViewSynthesis`` whose weights
    every device copies; else the committed checkpoint is loaded once.

    :attr:`row_split` says whether Deep3D is split by rows over ``tile``
    (else frames are dealt whole; set it False to deal them), and
    :attr:`halo` what the last split exchanged (``rounds`` per forward and
    ``bytes`` over all groups).  :attr:`graph_splits` says whether the
    split synthesis is replayed from a CUDA graph (every device of the
    mesh one card); set it False to run it eagerly."""

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
            synthesis = RightViewSynthesis(output_shape=out_shape,
                                           checkpoint_dir=checkpoint_dir,
                                           compute_dtype=compute_dtype,
                                           device=devices[0])
        self.synthesis = synthesis
        self.replicas = {dev: synthesis if same_device(synthesis.device, dev)
                         else synthesis.to(dev) for dev in devices}
        (fh, fw), (dh, dw) = (synthesis.model_full_shape,
                              synthesis.model_down_shape)
        self.row_split = (self._tile > 1
                          and dh % (DEEP3D_ROW_STRIDE * self._tile) == 0
                          and (fh, fw) == (4 * dh, 4 * dw))
        self.halo = None
        self.graph_splits = devices[0].type == "cuda" and len(devices) == 1
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
        if left.shape[0] % self.batch_group:
            raise ValueError(f"batch {left.shape[0]} not divisible by the "
                             f"data x disp mesh extent {self.batch_group}")
        placement = frame_devices(self.mesh, left.shape[0])
        with torch.no_grad():
            if self.row_split:
                rights = self._synthesize_split(left)
                frames = [(compute_disparity_map(
                    l.to(dev, torch.float32), r.to(dev), self.config), r)
                    for dev, l, r in zip(placement, left, rights)]
            else:
                frames = [self._frame(dev, l)
                          for dev, l in zip(placement, left)]
        first = self.mesh.first_device
        disparity = torch.stack([d.to(first) for d, _ in frames])
        if not return_right:
            return disparity
        return disparity, torch.stack([r.to(first) for _, r in frames])

    def _synthesize_split(self, left: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) 0..255 -> the right views (N, 3, *output shape) on
        the mesh's first device, each group's frames split by rows over its
        ``tile`` devices; replayed from a CUDA graph when
        :attr:`graph_splits`."""
        data, _, disp = self.mesh.shape
        groups = [list(self.mesh.devices[d, :, p]) for d in range(data)
                  for p in range(disp)]
        program = functools.partial(self._split_program, groups)
        if not self.graph_splits:
            (right,), self.halo = program(left)
            return right
        left = left.to(self.mesh.first_device, torch.float32)
        (right,), self.halo = self._shard_threads.replay(
            (tuple(map(tuple, groups)), tuple(left.shape)), program, left)
        return right

    def _split_program(self, groups, left):
        from ..synthesis.right_view_synthesis import (resize_nchw,
                                                      synthesize_rows)

        s = self.synthesis
        per_group = left.shape[0] // len(groups)
        splits = []
        for g, devices in enumerate(groups):
            # The resizes of synthesize_net_batch, on the whole frames.
            lg = left[g * per_group:(g + 1) * per_group].to(devices[0],
                                                             torch.float32)
            views = [resize_nchw(lg, shape) / 255.0
                     for shape in (s.model_full_shape, s.model_down_shape)]
            per = [v.shape[-2] // self._tile for v in views]
            splits.append([(dev, functools.partial(
                synthesize_rows, self.replicas[dev].model,
                *(v[..., t * p:(t + 1) * p, :].to(dev)
                  for v, p in zip(views, per)), s.compute_dtype))
                for t, dev in enumerate(devices)])
        results, exchanges = self._shard_threads.run(splits)
        first = self.mesh.first_device
        right = torch.cat([torch.cat([r.to(devices[0]) for r in shards],
                                     dim=-2).to(first)
                           for devices, shards in zip(groups, results)])
        out_shape = (self.config.height, self.config.width)
        if tuple(out_shape) != tuple(s.model_full_shape):
            right = resize_nchw(right, out_shape)
        return (right,), dict(rounds=exchanges[0].rounds,
                              bytes=sum(e.bytes for e in exchanges))

    def warmup(self) -> None:
        x = torch.zeros((self.batch_group, 3, self.config.height,
                         self.config.width))
        self.process_batch(x)
