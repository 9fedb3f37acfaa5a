"""Multi-block matching (MBM) cost aggregation
(port of ``stereo_tpu/ops/aggregation.py``).

The aggregate is the product ``(horizontal * vertical) * center`` of three
wrap box sums of each cost plane: (2s+1)x(2L+1), (2L+1)x(2s+1) and
(2m+1)^2.  The products exceed 2^24, so the multiplication order is part
of the result.
"""

from __future__ import annotations

import torch

from .boxfilter import box_sum_2d


def mbm_aggregate(cost_volume: torch.Tensor, small_radius: int,
                  mid_radius: int, large_radius: int) -> torch.Tensor:
    """(H, W, D) raw cost -> (H, W, D) aggregated cost."""
    cv = torch.movedim(cost_volume, -1, 0)
    horizontal = box_sum_2d(cv, small_radius, large_radius)
    vertical = box_sum_2d(cv, large_radius, small_radius)
    center = box_sum_2d(cv, mid_radius, mid_radius)
    return torch.movedim(horizontal * vertical * center, 0, -1)
