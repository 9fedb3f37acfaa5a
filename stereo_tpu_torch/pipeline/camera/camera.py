"""Camera abstractions: frame sources for the depth-estimation pipeline
(a copy of ``stereo_tpu/pipeline/camera/camera.py``).

Focal length, baseline, static image shape, disparity range, and streaming
of (left, right-or-None) pairs.  Frames are host NumPy arrays, CHW float32
in 0..255, as in the JAX package; the pipeline uploads them.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Iterator, Optional, Tuple

import numpy as np


class Camera(ABC):
    """A stream of stereo (or single-view) frames plus calibration."""

    @abstractmethod
    def focal_length(self) -> float:
        ...

    @abstractmethod
    def baseline(self) -> float:
        ...

    @abstractmethod
    def get_image_shape(self) -> Tuple[int, int]:
        """(H, W) of every streamed frame (the pipeline's static shape)."""
        ...

    @abstractmethod
    def get_disparity_boundaries(self) -> Tuple[int, int]:
        """(min_disparity, max_disparity) in full-resolution pixels."""
        ...

    @abstractmethod
    def stream_image_pairs(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        """Yield (left, right) CHW frames; right may be None (single-view
        mode — the pipeline will synthesize it)."""
        ...


class EvaluationCamera(Camera):
    """A camera that can also supply ground-truth disparity maps."""

    @abstractmethod
    def stream_image_pairs_with_gt_disparity(
            self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]:
        """Yield (left, right-or-None, gt_disparity) triplets; gt is (H, W)
        float32 with 0 marking missing ground truth."""
        ...
