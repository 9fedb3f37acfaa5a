"""The classical matcher through the two CUDA kernels
(port of ``stereo_tpu/ops/pallas/classical_fused.py``).

grayscale -> mean_pool -> ``matching_core`` -> ``sampled_window`` ->
``refine_from_window`` -> vertical fill -> horizontal fill.  On CPU tensors
the two kernel wrappers take their plain versions.
"""

from __future__ import annotations

import torch

from ..core.config import MatchingConfig
from .cuda import matching_core, sampled_window
from .fills import horizontal_fill, upscale_vertical_fill
from .imageops import mean_pool
from .refinement import refine_from_window


def compute_disparity_from_grayscale(left_gray: torch.Tensor,
                                     right_gray: torch.Tensor,
                                     config: MatchingConfig) -> torch.Tensor:
    c = config
    left_down = mean_pool(left_gray, c.k)
    right_down = mean_pool(right_gray, c.k)

    disparity_down, mbm = matching_core(left_down, right_down, c)
    window = sampled_window(left_gray, right_gray, disparity_down, c)

    refined = refine_from_window(torch.movedim(window, 0, -1), disparity_down,
                                 mbm[0], mbm[1], mbm[2], c.k)
    vfilled = upscale_vertical_fill(left_gray, refined, c.k, float(c.threshold))
    return horizontal_fill(left_gray, vfilled, c.k, float(c.threshold))
