"""The stereo networks over a (data, tile, disp) mesh
(port of ``stereo_tpu/parallel/dnn.py``).

The JAX engine annotates batch and row shardings at the jit boundary and
lets XLA's SPMD partitioner split every convolution by rows, inserting the
halo exchanges itself.  PyTorch has no partitioner for these 3-D networks,
so the port keeps the JAX contract and spreads frames instead:

* the batch splits over ``data`` x ``disp`` (the batch group), as in JAX;
* the frames of a group are dealt round-robin over that group's ``tile``
  devices, where JAX splits each frame's rows over them;
* each frame runs the single-device network (``eval()``: the kernels on
  the card) on its device.

The result is the same; only the placement differs.  Splitting rows over
``tile`` inside a network is an open item of the port (ROADMAP §1).  Each
distinct device of the mesh holds one replica of the weights, loaded once
and copied to the others.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.config import MeshConfig
from .mesh import Mesh, make_mesh


def frame_devices(mesh: Mesh, n: int) -> list:
    """The device of each frame of an n-frame batch: the batch splits into
    the ``data`` x ``disp`` groups (data major), and a group's frames are
    dealt round-robin over its ``tile`` devices."""
    data, tile, disp = mesh.shape
    per_group = n // (data * disp)
    devices = []
    for i in range(n):
        group, j = divmod(i, per_group)
        d, p = divmod(group, disp)
        devices.append(mesh.devices[d, j % tile, p])
    return devices


class ShardedDnnEngine:
    """Batched DNN stereo inference over a (data, tile, disp) mesh
    (default: the first ``mesh_config.num_devices`` cards).
    ``process_batch`` expects the batch divisible by :attr:`batch_group`
    (= data x disp) and the image height divisible by ``tile``."""

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
        first, *others = self.mesh.distinct_devices()
        backend = DnnStereoMatchingBackend(
            model_name, image_shape, max_disparity=max_disparity,
            state_dict=state_dict, checkpoint_dir=checkpoint_dir,
            compute_dtype=compute_dtype, device=first)
        self.weights = backend.weights
        self.replicas = {first: backend}
        self.replicas.update({dev: backend.to(dev) for dev in others})

    def process_batch(self, left_batch, right_batch) -> torch.Tensor:
        """(N, 3, H, W) x2 in 0..255 -> (N, H, W) float32 disparities on
        the mesh's first device.  N must be a multiple of
        :attr:`batch_group`."""
        left = torch.as_tensor(left_batch)
        right = torch.as_tensor(right_batch)
        if left.shape[0] % self.batch_group:
            raise ValueError(f"batch {left.shape[0]} not divisible by the "
                             f"data x disp mesh extent {self.batch_group}")
        out = [self.replicas[dev].process(l, r) for dev, l, r in
               zip(frame_devices(self.mesh, left.shape[0]), left, right)]
        first = self.mesh.first_device
        return torch.stack([d.to(first) for d in out])

    def warmup(self) -> None:
        x = torch.zeros((self.batch_group, 3, *self.image_shape))
        self.process_batch(x, x)
