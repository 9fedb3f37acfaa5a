"""Frame sources of the pipeline: KITTI drives, Middlebury scenes and
generated stereo scenes with exact ground truth."""

from .camera import Camera, EvaluationCamera
from .kitti import KittiSingleViewCamera
from .middlebury import (MiddleburyCalibration, MiddleburyStereoCamera,
                         load_middlebury_calibration)
from .synthetic import SyntheticStereoCamera

__all__ = [
    "Camera", "EvaluationCamera", "KittiSingleViewCamera",
    "MiddleburyCalibration", "MiddleburyStereoCamera",
    "load_middlebury_calibration", "SyntheticStereoCamera",
]
