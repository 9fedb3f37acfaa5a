"""Winner-take-all disparity selection (port of ``stereo_tpu/ops/wta.py``).

``torch.argmax`` returns the first maximal index, the reference's strict
``>`` scan (first maximum wins).
"""

from __future__ import annotations

import torch


def wta_disparity(aggregated_volume: torch.Tensor,
                  min_disparity: int) -> torch.Tensor:
    """(H, W, D) -> (H, W) float disparities = argmax_d + min_disparity."""
    best = torch.argmax(aggregated_volume, dim=-1)
    return (best + min_disparity).to(aggregated_volume.dtype)
