"""KITTI raw-drive single-view camera (port of
``stereo_tpu/pipeline/camera/kitti.py``).

Behavioral parity with the reference's ``KittiSingleViewCamera``
(``pipeline/camera/kitti_single_view_camera.py``):

* streams sorted stereo pairs of a raw drive (``image_02``/``image_03``);
* pads 375x1242 frames to 384x1280 with zeros, offsets (left=19, top=5,
  right=19, bottom=4) — so the padded width/height are multiples of the
  downscale factor and the VGG stride;
* fixed advertised shape (384, 1280) and disparity range (0, 64);
* ground-truth disparity from Velodyne scans: project to the image plane,
  ``d = baseline * focal / depth``, inf -> 0, then the same padding.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ...utils.image_io import pad_image, read_kitti_drive_stereo_pairs
from ...utils.velodyne import generate_depth_map, get_focal_length_baseline
from .camera import EvaluationCamera

# torchvision Pad order (left, top, right, bottom); reference :23.
KITTI_PAD = (19, 5, 19, 4)
KITTI_RAW_SHAPE = (375, 1242)
KITTI_PADDED_SHAPE = (384, 1280)
KITTI_DISPARITY_RANGE = (0, 64)


class KittiSingleViewCamera(EvaluationCamera):

    def __init__(self, drive_dir: str, return_right_view: bool = False,
                 only_one: bool = False):
        self._drive_dir = drive_dir
        self._calib_dir = os.path.dirname(os.path.normpath(drive_dir))
        lefts, rights = read_kitti_drive_stereo_pairs(drive_dir)
        self._left_images: List[str] = sorted(lefts)
        self._right_images: List[str] = sorted(rights)
        self._return_right_view = return_right_view
        self._only_one = only_one
        self._focal_length, self._baseline = get_focal_length_baseline(self._calib_dir)

    def focal_length(self) -> float:
        return self._focal_length

    def baseline(self) -> float:
        return self._baseline

    def get_image_shape(self) -> Tuple[int, int]:
        return KITTI_PADDED_SHAPE

    def get_disparity_boundaries(self) -> Tuple[int, int]:
        return KITTI_DISPARITY_RANGE

    def __len__(self) -> int:
        return 1 if self._only_one else len(self._left_images)

    def stream_image_pairs(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        for left_path, right_path in zip(self._left_images, self._right_images):
            right = self._load_view(right_path) if self._return_right_view else None
            yield self._load_view(left_path), right
            if self._only_one:
                break

    def stream_image_pairs_with_gt_disparity(
            self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]:
        for left_path, right_path in zip(self._left_images, self._right_images):
            left = self._load_view(left_path)
            right = self._load_view(right_path) if self._return_right_view else None
            yield left, right, self._load_gt_disparity(left_path)
            if self._only_one:
                break

    def _load_view(self, path: str) -> np.ndarray:
        from ... import _native

        # Native single-pass decode and pad.
        return _native.decode_png_padded_chw(path, pad=KITTI_PAD)

    def _load_gt_disparity(self, left_image_path: str) -> np.ndarray:
        velo_path = self._velodyne_path(left_image_path)
        depth = generate_depth_map(self._calib_dir, velo_path,
                                   im_shape=KITTI_RAW_SHAPE, vel_depth=True)
        with np.errstate(divide="ignore"):
            disparity = self._baseline * self._focal_length / depth
        disparity[np.isinf(disparity)] = 0.0
        return pad_image(disparity.astype(np.float32), *KITTI_PAD)

    @staticmethod
    def _velodyne_path(left_image_path: str) -> str:
        return left_image_path.replace("image_02", "velodyne_points").replace(
            ".png", ".bin")
