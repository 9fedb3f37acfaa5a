"""Synthetic evaluation camera: procedural stereo scenes with exact ground
truth (port of ``stereo_tpu/pipeline/camera/synthetic.py``).

It streams scenes of the port's generator (``train.synthetic``, the JAX
package's key stream) through the same pipeline and metrics as a KITTI
drive, so the accuracy gate (D1, thresholds, MAE) runs without a dataset;
a seed gives the JAX camera's scenes.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from .camera import EvaluationCamera


class SyntheticStereoCamera(EvaluationCamera):
    """Streams ``n_frames`` generated scenes as (left, right, gt) triplets,
    CHW float32 numpy frames in 0..255 and (H, W) disparities.

    ``seed`` selects the scene set; with ``return_right_view=False`` the
    right view is withheld and the pipeline synthesizes it.
    ``depth_prior`` selects the scene family
    (``train.synthetic.synthetic_stereo_scene``): ``False`` for stereo
    matching, ``True`` for single-view synthesis, whose appearance predicts
    depth.  ``drive_speed`` > 0 keeps one scene layout and moves the rig
    by that many baselines per frame.  Scenes are made on ``device``
    (default the CPU: the pipeline uploads frames itself).
    """

    def __init__(self, n_frames: int = 8, height: int = 256,
                 width: int = 512, min_scene_disparity: float = 6.0,
                 max_scene_disparity: float = 58.0,
                 disparity_boundaries: Tuple[int, int] = (0, 64),
                 return_right_view: bool = True, seed: int = 1234,
                 focal_length: float = 720.0, baseline: float = 0.54,
                 depth_prior: bool = False, drive_speed: float = 0.0,
                 device="cpu"):
        self._n = n_frames
        self._h, self._w = height, width
        self._dmin, self._dmax = min_scene_disparity, max_scene_disparity
        self._bounds = disparity_boundaries
        self._return_right = return_right_view
        self._seed = seed
        self._f, self._b = focal_length, baseline
        self._depth_prior = depth_prior
        self._drive_speed = drive_speed
        self._device = device

    def __len__(self) -> int:
        return self._n

    def focal_length(self) -> float:
        return self._f

    def baseline(self) -> float:
        return self._b

    def get_image_shape(self) -> Tuple[int, int]:
        return (self._h, self._w)

    def get_disparity_boundaries(self) -> Tuple[int, int]:
        return self._bounds

    def _scene(self, index: int):
        from ...train import prng
        from ...train.synthetic import synthetic_stereo_scene

        if self._drive_speed:
            key = prng.PRNGKey(self._seed)          # one scene layout
            camera_t = index * self._drive_speed
        else:
            key = prng.fold_in(prng.PRNGKey(self._seed), index)
            camera_t = 0.0
        scene = synthetic_stereo_scene(
            key, self._h, self._w, self._dmin, self._dmax, 6,
            self._depth_prior, False, camera_t, device=self._device)
        return tuple(a.cpu().numpy() for a in scene)

    def stream_image_pairs(self) -> Iterator[
            Tuple[np.ndarray, Optional[np.ndarray]]]:
        for i in range(self._n):
            left, right, _ = self._scene(i)
            yield left, (right if self._return_right else None)

    def stream_image_pairs_with_gt_disparity(self) -> Iterator[
            Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]:
        for i in range(self._n):
            left, right, gt = self._scene(i)
            yield left, (right if self._return_right else None), gt
