"""Secondary matching: full-resolution SAD scan with parabola-fit subpixel
refinement (port of ``stereo_tpu/ops/refinement.py``;
reference ``csrc/depth/kernels/secondary_matching.cu:22-99``).

For each downscaled pixel with MBM winner ``d_mbm`` the window of
full-resolution inverted-SAD similarities at centre ``(k*y, k*x)`` over
disparities ``k*(d_mbm-1)-1 .. k*(d_mbm+1)+1`` is scanned (first maximum
wins), and the MBM and SAD parabola peaks are combined
(``secondary_matching.cu:63-70``).  MBM neighbours are taken mod D and
column indices wrap mod W, as in the JAX package.
"""

from __future__ import annotations

import torch

from .boxfilter import box_sum_1d
from .cost_volume import MAX_INTENSITY
from .gather import take_lane, take_window_lanes


def quadratic_function_peak(x1, y1, x2, y2, x3, y3):
    """Vectorized ``device_functions.cuh:22-46``: the parabola vertex when
    the fit opens downwards, else the x of the largest y (reference
    tie-breaking)."""
    denominator = (x1 - x2) * (x2 - x3) * (x1 - x3)
    fallback = torch.where(y1 > y2,
                           torch.where(y1 > y3, x1, x3),
                           torch.where(y2 > y3, x2, x3))
    a = x3 * (y2 - y1) + x2 * (y1 - y3) + x1 * (y3 - y2)
    b = x1 * x1 * (y2 - y3) + x3 * x3 * (y1 - y2) + x2 * x2 * (y3 - y1)
    vertex = -b / (2.0 * a)
    use_vertex = (denominator != 0) & (a < 0)
    return torch.where(use_vertex, vertex, fallback)


def _have_same_sign(a, b):
    """``device_functions.cuh:48-51``: strict product positivity."""
    return (a * b) > 0


def sampled_sad_volume(left: torch.Tensor, right: torch.Tensor, k: int,
                       patch_radius: int, d_start: int, num_d: int,
                       rows_prepadded: bool = False) -> torch.Tensor:
    """Dense inverted-SAD similarity at full resolution, sampled on the
    stride-``k`` grid of downscaled pixel centres: (ceil(H/k), ceil(W/k),
    num_d); entry ``t`` is at full-res disparity ``d_start + t``.  With
    ``rows_prepadded`` the images carry ``patch_radius`` more rows above
    and below, which do not wrap.

    Rows are summed first (then sampled), then columns, each in index
    order: the order the CUDA kernel ``sampled_window`` follows.
    """
    area = (2 * patch_radius + 1) ** 2
    planes = []
    for t in range(num_d):
        diff = torch.abs(left - torch.roll(right, d_start + t, dims=-1))
        rows = box_sum_1d(diff, patch_radius, axis=-2,
                          prepadded=rows_prepadded)[..., ::k, :]
        cols = box_sum_1d(rows, patch_radius, axis=-1)[..., ::k]
        planes.append(area * MAX_INTENSITY - cols)
    return torch.stack(planes, dim=-1)


def secondary_matching(left_gray: torch.Tensor, right_gray: torch.Tensor,
                       aggregated_volume: torch.Tensor,
                       disparity: torch.Tensor, k: int, patch_radius: int,
                       min_disparity_down: int) -> torch.Tensor:
    """Refine the WTA ``disparity`` map (downscaled units) to subpixel."""
    num_dd = aggregated_volume.shape[-1]
    win = 2 * k + 3
    d_idx = disparity.to(torch.int64) - min_disparity_down
    d_start = k * (min_disparity_down - 1) - 1
    num_d = k * (num_dd + 1) + 3
    sampled_sad = sampled_sad_volume(left_gray, right_gray, k, patch_radius,
                                     d_start, num_d)
    window = take_window_lanes(sampled_sad, k * d_idx, win)

    def mbm_cost(j):
        return take_lane(aggregated_volume, torch.remainder(d_idx + j, num_dd))

    return refine_from_window(window, disparity, mbm_cost(-1), mbm_cost(0),
                              mbm_cost(1), k)


def refine_from_window(window: torch.Tensor, disparity: torch.Tensor,
                       mbm_prev: torch.Tensor, mbm_center: torch.Tensor,
                       mbm_next: torch.Tensor, k: int) -> torch.Tensor:
    """Combine rule given each pixel's (..., 2k+3) dense-SAD ``window``
    (taps around ``k*(d_mbm-1)-1``) and its three MBM parabola costs
    (``secondary_matching.cu:45-70``)."""
    scan = window[..., 1:-1]
    d_mbm = disparity.to(torch.int64)
    best_slot = torch.argmax(scan, dim=-1)
    c_sad = take_lane(scan, best_slot)
    d_sad = k * (d_mbm - 1) + best_slot
    interior = (best_slot > 0) & (best_slot < 2 * k)

    y_sad_next = take_lane(window, best_slot + 2)
    y_sad_prev = take_lane(window, best_slot)

    fd = disparity
    d_sad_f = d_sad.to(fd.dtype)
    peak_mbm = quadratic_function_peak(fd, mbm_center, fd + 1.0, mbm_next,
                                       fd - 1.0, mbm_prev)
    peak_sad = quadratic_function_peak(d_sad_f, c_sad, d_sad_f + 1.0,
                                       y_sad_next, d_sad_f - 1.0, y_sad_prev)

    delta_mbm = peak_mbm - fd
    sad_subpixel = d_sad_f + (peak_sad - d_sad_f)
    agree = _have_same_sign(delta_mbm, sad_subpixel - k * fd)
    refined = torch.where(agree, sad_subpixel / k,
                          (fd + delta_mbm + sad_subpixel / k) / 2.0)
    return torch.where(interior, refined, fd)
