"""Single-view engine: the headline scenario, one left view in, disparity
out (port of ``stereo_tpu/pipeline/single_view.py``).

Deep3D synthesizes the right view, then the stereo-matching backend runs
on the ORIGINAL left view and the synthesized right view (not on the
resized or normalised left view), as in the reference's
``depth_estimation_pipeline.py:55-66`` composition.  On a CUDA device the
path runs hand-written kernels in every frame: ``upsample_blend``, then
``matching_core`` and ``sampled_window`` (classical backend) or
``gwc_volume`` (GwcNet).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from ..utils.profiling import StageTimer


class SingleViewEngine:
    """``backend``: a stereo-matching backend with ``process_batch(left,
    right)`` on the synthesis's device; ``synthesis``: a constructed
    ``RightViewSynthesis`` whose output shape is the backend's image
    shape.  ``timer`` (optional) records the two stages."""

    def __init__(self, backend, synthesis,
                 timer: Optional[StageTimer] = None):
        self.backend = backend
        self.synthesis = synthesis
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
            disparity = self.backend.process_batch(left, right)
        return disparity, right
