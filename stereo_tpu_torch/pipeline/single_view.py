"""Single-view engine: the headline scenario, one left view in, disparity
out (port of ``stereo_tpu/pipeline/single_view.py``).

Deep3D synthesizes the right view, then the classical matcher runs on the
ORIGINAL left view and the synthesized right view (not on the resized or
normalised left view), as in the reference's
``depth_estimation_pipeline.py:55-66`` composition.  On a CUDA device the
path runs three hand-written kernels per frame: ``upsample_blend``,
``matching_core`` and ``sampled_window``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from ..core.config import MatchingConfig
from ..matching.classical import ClassicalStereoEngine
from ..utils.profiling import StageTimer


class SingleViewEngine:
    """``synthesis`` is a constructed ``RightViewSynthesis`` whose output
    shape is the matcher's image shape; its device is the engine's.
    ``timer`` (optional) records the two stages."""

    def __init__(self, config: MatchingConfig, synthesis,
                 timer: Optional[StageTimer] = None):
        self.config = config
        self.synthesis = synthesis
        self.engine = ClassicalStereoEngine(config, device=synthesis.device)
        self.timer = timer

    def _stage(self, name: str):
        return self.timer.stage(name) if self.timer else contextlib.nullcontext()

    def process(self, left_image) -> Tuple[torch.Tensor, torch.Tensor]:
        """(3, H, W) 0..255 -> ``(disparity (H, W), right (3, H, W))``."""
        disparity, right = self.process_batch(torch.as_tensor(left_image)[None])
        return disparity[0], right[0]

    def process_batch(self, left_batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, 3, H, W) -> ``(disparity (N, H, W), right (N, 3, H, W))``."""
        left = torch.as_tensor(left_batch).to(self.synthesis.device,
                                              torch.float32)
        with self._stage("right_view_generation"):
            right = self.synthesis.process_batch(left)
        with self._stage("stereo_matching"):
            disparity = self.engine.compute_disparity_maps(left, right)
        return disparity, right
