"""Deep3D's shifted-view blend (port of ``stereo_tpu/ops/shift_stack.py``).

``weighted_shift_sum`` is the plain half of the ``upsample_blend`` kernel:
``out[n, c, y, x] = sum_d w[n, d, y, x] * view[n, c, y, x + d]``, with the
view taken as zero past the right edge.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shift_cols(x: torch.Tensor, d: int) -> torch.Tensor:
    """``out[..., y] = x[..., y + d]`` with zero fill: ``d > 0`` moves the
    content left, ``d < 0`` right; all zeros once ``|d|`` reaches the
    width."""
    if d == 0:
        return x
    w = x.shape[-1]
    if d > 0:
        return F.pad(x[..., d:], (0, min(d, w)))
    return F.pad(x[..., :max(d, -w)], (min(-d, w), 0))


def disparity_shift_stack(left_nchw: torch.Tensor, min_disparity: int,
                          max_disparity: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, D, C, H, W) stack of the views shifted by each
    disparity in ``min_disparity..max_disparity``."""
    return torch.stack([_shift_cols(left_nchw, d)
                        for d in range(min_disparity, max_disparity + 1)],
                       dim=1)


def weighted_shift_sum(weights_ndhw: torch.Tensor,
                       view_nchw: torch.Tensor) -> torch.Tensor:
    """Sum over d of ``weights[:, d] * left_shift(view, d)``.

    ``weights``: (N, D, H, W); ``view``: (N, C, H, W).  Returns (N, C, H, W).
    """
    out = torch.zeros_like(view_nchw)
    for d in range(weights_ndhw.shape[1]):
        out = out + weights_ndhw[:, d][:, None] * _shift_cols(view_nchw, d)
    return out
