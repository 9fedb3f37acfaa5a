"""Middlebury stereo-scene camera, one calibrated pair per scene (port of
``stereo_tpu/pipeline/camera/middlebury.py``).

Behavioral parity with the reference's ``MiddleBuryStereoCamera``
(``pipeline/camera/middlebury_stereo_camera.py``): reads ``im0.png`` /
``im1.png`` / ``calib.txt`` from a scene directory; disparity bounds come
from the calib's ``vmin``/``vmax``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Iterator, Optional, Tuple

import numpy as np

from ...utils.image_io import read_image_chw
from .camera import Camera


@dataclasses.dataclass
class MiddleburyCalibration:
    """Parsed ``calib.txt`` of a Middlebury 2014+ scene."""

    cam0: np.ndarray
    cam1: np.ndarray
    doffs: float
    baseline: float
    width: int
    height: int
    ndisp: int
    vmin: int
    vmax: int

    @property
    def fx(self) -> float:
        return float(self.cam0[0, 0])

    @property
    def fy(self) -> float:
        return float(self.cam0[1, 1])

    @property
    def cx(self) -> float:
        return float(self.cam0[0, 2])

    @property
    def cy(self) -> float:
        return float(self.cam0[1, 2])

    def get_focal_length(self) -> Tuple[float, float]:
        return self.fx, self.fy

    def get_principal_point(self) -> Tuple[float, float]:
        return self.cx, self.cy


def _parse_matrix(text: str) -> np.ndarray:
    rows = re.sub(r"[\[\]]", "", text).split(";")
    return np.array([[float(v) for v in row.split()] for row in rows])


_PARSERS = {
    "cam0": _parse_matrix, "cam1": _parse_matrix,
    "doffs": float, "baseline": float,
    "width": int, "height": int, "ndisp": int, "vmin": int, "vmax": int,
}


def load_middlebury_calibration(path: str) -> MiddleburyCalibration:
    values = {}
    with open(path, "r") as f:
        for line in f:
            if "=" not in line:
                continue
            key, raw = line.split("=", 1)
            key = key.strip()
            if key in _PARSERS:
                values[key] = _PARSERS[key](raw.strip())
    return MiddleburyCalibration(**values)


class MiddleburyStereoCamera(Camera):

    def __init__(self, scene_dir: str):
        if not os.path.exists(scene_dir):
            raise RuntimeError(f"Directory '{scene_dir}' not found.")
        self._left_image = read_image_chw(os.path.join(scene_dir, "im0.png"))
        self._right_image = read_image_chw(os.path.join(scene_dir, "im1.png"))
        self._calibration = load_middlebury_calibration(
            os.path.join(scene_dir, "calib.txt"))

    @property
    def calibration(self) -> MiddleburyCalibration:
        return self._calibration

    def focal_length(self) -> float:
        return self._calibration.fx

    def baseline(self) -> float:
        return self._calibration.baseline

    def get_image_shape(self) -> Tuple[int, int]:
        return self._calibration.height, self._calibration.width

    def get_disparity_boundaries(self) -> Tuple[int, int]:
        return self._calibration.vmin, self._calibration.vmax

    def __len__(self) -> int:
        return 1

    def stream_image_pairs(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        yield self._left_image, self._right_image
