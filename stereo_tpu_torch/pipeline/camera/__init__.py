"""Frame sources of the pipeline.  The JAX package's synthetic camera
(``stereo_tpu/pipeline/camera/synthetic.py``) draws its scenes with the
training package's generator, so it comes with the port of training."""

from .camera import Camera, EvaluationCamera
from .kitti import KittiSingleViewCamera
from .middlebury import (MiddleburyCalibration, MiddleburyStereoCamera,
                         load_middlebury_calibration)

__all__ = [
    "Camera", "EvaluationCamera", "KittiSingleViewCamera",
    "MiddleburyCalibration", "MiddleburyStereoCamera",
    "load_middlebury_calibration",
]
