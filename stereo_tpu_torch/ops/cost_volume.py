"""Inverted-SAD matching cost volume (port of ``stereo_tpu/ops/cost_volume.py``).

    cost(y, x, d) = sum_{|i|<=r, |j|<=r} 255 - |L[y+i, x+j] - R[y+i, x+j-d]|

Higher is better; borders wrap, and ``roll(R, d)[.., x] == R[.., (x-d) mod W]``.
"""

from __future__ import annotations

import torch

from .boxfilter import box_sum_2d

MAX_INTENSITY = 255.0


def sad_similarity_plane(left: torch.Tensor, right: torch.Tensor,
                         disparity: int, patch_radius: int) -> torch.Tensor:
    """Inverted-SAD similarity for one static ``disparity``: (H, W) -> (H, W)."""
    diff = torch.abs(left - torch.roll(right, disparity, dims=-1))
    area = (2 * patch_radius + 1) ** 2
    return area * MAX_INTENSITY - box_sum_2d(diff, patch_radius, patch_radius)


def sad_cost_volume(left: torch.Tensor, right: torch.Tensor,
                    min_disparity: int, max_disparity: int,
                    patch_radius: int,
                    rows_prepadded: bool = False) -> torch.Tensor:
    """(H, W, D) similarity volume; ``volume[..., i]`` is the cost at
    disparity ``min_disparity + i``.  With ``rows_prepadded`` the inputs
    carry ``patch_radius`` more rows above and below, which do not wrap:
    (H + 2r, W) -> (H, W, D)."""
    num_d = max_disparity - min_disparity + 1
    rolled = torch.stack([torch.roll(right, min_disparity + i, dims=-1)
                          for i in range(num_d)], dim=0)
    diff = torch.abs(left[None] - rolled)
    area = (2 * patch_radius + 1) ** 2
    cost = area * MAX_INTENSITY - box_sum_2d(diff, patch_radius, patch_radius,
                                             rows_prepadded=rows_prepadded)
    return torch.movedim(cost, 0, -1)
