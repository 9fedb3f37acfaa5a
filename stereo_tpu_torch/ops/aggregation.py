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
                  mid_radius: int, large_radius: int,
                  rows_prepadded: bool = False) -> torch.Tensor:
    """(H, W, D) raw cost -> (H, W, D) aggregated cost.  With
    ``rows_prepadded`` the volume carries ``max(radii)`` more rows above
    and below, which do not wrap: (H + 2 * max(radii), W, D) -> (H, W, D)."""
    cv = torch.movedim(cost_volume, -1, 0)
    halo = max(small_radius, mid_radius, large_radius)
    h = cv.shape[-2] - 2 * halo

    def box(radius_rows, radius_cols):
        if not rows_prepadded:
            return box_sum_2d(cv, radius_rows, radius_cols)
        rows = cv.narrow(-2, halo - radius_rows, h + 2 * radius_rows)
        return box_sum_2d(rows, radius_rows, radius_cols, rows_prepadded=True)

    horizontal = box(small_radius, large_radius)
    vertical = box(large_radius, small_radius)
    center = box(mid_radius, mid_radius)
    return torch.movedim(horizontal * vertical * center, 0, -1)
