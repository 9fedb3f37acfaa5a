"""Stereo-matching backends (port of ``stereo_tpu/pipeline/backends.py``;
the classical backend only in this slice of the port)."""

from __future__ import annotations

from abc import ABC, abstractmethod

import torch

from ..core.config import MatchingConfig
from ..matching.classical import ClassicalStereoEngine


class StereoMatchingBackend(ABC):
    """(3, H, W) left/right RGB in 0..255 -> (H, W) float disparity."""

    @abstractmethod
    def process(self, left_image, right_image) -> torch.Tensor:
        ...


class ClassicalStereoBackend(StereoMatchingBackend):
    """The classical multi-block-matching engine."""

    def __init__(self, config: MatchingConfig, device="cuda"):
        self.engine = ClassicalStereoEngine(config, device=device)

    def process(self, left_image, right_image) -> torch.Tensor:
        return self.engine.compute_disparity_map(left_image, right_image)

    def process_batch(self, left_batch, right_batch) -> torch.Tensor:
        return self.engine.compute_disparity_maps(left_batch, right_batch)
