"""Single-view depth over a (data, tile, disp) mesh: Deep3D right-view
synthesis, then classical matching (port of
``stereo_tpu/parallel/synthesis.py``).

The JAX engine runs Deep3D partitioned by GSPMD (batch over ``data`` x
``disp``, rows over ``tile``), then the exact single-frame matcher per
frame on each batch shard (``shard_map`` + ``lax.map``).  The port places
frames as ``parallel.dnn`` does — the batch splits over the ``data`` x
``disp`` groups and a group's frames are dealt round-robin over its
``tile`` devices — and each device runs Deep3D and then the single-device
classical program on its frames: no traffic between devices but the
frames and the results.  On the card that launches ``upsample_blend``,
``matching_core`` and ``sampled_window`` on every shard.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import MatchingConfig, MeshConfig
from .dnn import frame_devices
from .mesh import Mesh, make_mesh, same_device


class ShardedSingleViewEngine:
    """Batched single-view depth (left views only -> disparities) over a
    (data, tile, disp) mesh (default: the first ``mesh_config.num_devices``
    cards).  ``process_batch`` expects the batch divisible by
    :attr:`batch_group` (= data x disp) and the image height divisible by
    ``tile``.  ``synthesis``: a built ``RightViewSynthesis`` whose weights
    every device copies; else the committed checkpoint is loaded once."""

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

    def _frame(self, device, left: torch.Tensor):
        from ..matching.classical import compute_disparity_map

        left = left.to(device, torch.float32)
        right = self.replicas[device].process_batch(left[None])[0]
        return compute_disparity_map(left, right, self.config), right

    def process_batch(self, left_batch, return_right: bool = False):
        """(N, 3, H, W) 0..255 left views -> (N, H, W) float32 disparities
        (and the synthesized right views when ``return_right``) on the
        mesh's first device.  N must be a multiple of :attr:`batch_group`."""
        left = torch.as_tensor(left_batch)
        if left.shape[0] % self.batch_group:
            raise ValueError(f"batch {left.shape[0]} not divisible by the "
                             f"data x disp mesh extent {self.batch_group}")
        with torch.no_grad():
            frames = [self._frame(dev, l) for dev, l in
                      zip(frame_devices(self.mesh, left.shape[0]), left)]
        first = self.mesh.first_device
        disparity = torch.stack([d.to(first) for d, _ in frames])
        if not return_right:
            return disparity
        return disparity, torch.stack([r.to(first) for _, r in frames])

    def warmup(self) -> None:
        x = torch.zeros((self.batch_group, 3, self.config.height,
                         self.config.width))
        self.process_batch(x)
