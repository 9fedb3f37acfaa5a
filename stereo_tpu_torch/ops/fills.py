"""Disparity upscaling with vertical and horizontal bilateral fills
(port of ``stereo_tpu/ops/fills.py``; reference
``csrc/depth/kernels/upscale_disparity_vertical_fill.cu:22-51`` and
``horizontal_disparity_fill.cu:22-40``).

The reference quirks are kept as the JAX package keeps them: the "next"
anchor of the vertical fill is the row above, its colour is read at row
``(k+1)*x`` (clamped to the last row), the top ``k-1`` rows replicate row 0's
anchor, and the right anchor of the last column band is clamped.
"""

from __future__ import annotations

import torch


def _select_fill(prev_d, next_d, prev_color, next_color, current_color,
                 i, k, threshold):
    """Linear interpolation ``prev + (i*(next - prev))/k`` within
    ``threshold``, else the anchor of nearer colour."""
    interp = prev_d + (i * (next_d - prev_d)) / k
    bilateral = torch.where(
        torch.abs(current_color - prev_color)
        <= torch.abs(current_color - next_color), prev_d, next_d)
    return torch.where(torch.abs(prev_d - next_d) <= threshold, interp,
                       bilateral)


def upscale_vertical_fill(left_gray: torch.Tensor,
                          disparity_down: torch.Tensor, k: int,
                          threshold: float) -> torch.Tensor:
    """(H, W) grayscale + (H_d, W_d) downscaled disparity -> (H, W_d)
    vertically filled map holding the values of full-res columns ``k*y``."""
    dev = left_gray.device
    h = left_gray.shape[-2]
    h_d, w_d = disparity_down.shape[-2:]
    scaled = k * disparity_down

    prev_d = scaled
    next_d = torch.cat([scaled[:1], scaled[:-1]], dim=0)

    grid_cols = left_gray[..., ::k][:, :w_d]
    kx = torch.arange(h_d, device=dev) * k
    prev_color = grid_cols[kx]
    next_rows = torch.clamp((k + 1) * torch.arange(h_d, device=dev), max=h - 1)
    next_color = grid_cols[next_rows]

    rows = [scaled]
    for i in range(1, k):
        current_color = grid_cols[torch.clamp(kx + i, max=h - 1)]
        fill = _select_fill(prev_d, next_d, prev_color, next_color,
                            current_color, float(i), float(k), threshold)
        fill = torch.cat([scaled[:1], fill[1:]], dim=0)
        rows.append(fill)

    stacked = torch.stack(rows, dim=1).reshape(h_d * k, w_d)
    return stacked[:h]


def horizontal_fill(left_gray: torch.Tensor, vfilled: torch.Tensor, k: int,
                    threshold: float) -> torch.Tensor:
    """(H, W) grayscale + (H, W_d) vertically filled columns -> (H, W)."""
    dev = left_gray.device
    h, w = left_gray.shape[-2:]
    w_d = vfilled.shape[-1]

    cols = []
    last = w_d - 1
    for m in range(k):
        prev_d = vfilled
        next_d = torch.cat([vfilled[:, 1:], vfilled[:, last:last + 1]], dim=1)
        if m == 0:
            cols.append(prev_d)
            continue
        grid = torch.arange(w_d, device=dev) * k
        prev_color = left_gray[:, ::k][:, :w_d]
        next_color = left_gray[:, torch.clamp(grid + k, max=w - 1)]
        current_color = left_gray[:, torch.clamp(grid + m, max=w - 1)]
        cols.append(_select_fill(prev_d, next_d, prev_color, next_color,
                                 current_color, float(m), float(k), threshold))

    stacked = torch.stack(cols, dim=-1).reshape(h, w_d * k)
    return stacked[:, :w]
