"""Wrappers of the classical matcher's two kernels, ``matching_core`` and
``sampled_window``, with their plain PyTorch versions.

The plain versions compose the stage ops (``ops.cost_volume``,
``ops.aggregation``, ``ops.wta``, ``ops.refinement``) and take the same
sums in the same order as the kernels, so on the same inputs the two agree
bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...core.config import MatchingConfig
from ..aggregation import mbm_aggregate
from ..cost_volume import sad_cost_volume
from ..gather import take_lane, take_window_lanes
from ..refinement import sampled_sad_volume
from ..wta import wta_disparity
from . import build
from .launch import LAUNCHES, check_cuda, use_kernel


def matching_core_plain(left_down: torch.Tensor, right_down: torch.Tensor,
                        config: MatchingConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: materialized cost volume, aggregation, first-max WTA
    and the aggregate at (winner - 1, winner, winner + 1) mod D."""
    c = config
    volume = sad_cost_volume(left_down, right_down, c.min_disparity_down,
                             c.max_disparity_down, c.cost_patch_radius)
    aggregated = mbm_aggregate(volume, c.small_mbm_radius, c.mid_mbm_radius,
                               c.large_mbm_radius)
    disparity = wta_disparity(aggregated, c.min_disparity_down)
    num_d = aggregated.shape[-1]
    d_idx = disparity.to(torch.int64) - c.min_disparity_down
    mbm = torch.stack([take_lane(aggregated, torch.remainder(d_idx + j, num_d))
                       for j in (-1, 0, 1)])
    return disparity, mbm


def matching_core(left_down: torch.Tensor, right_down: torch.Tensor,
                  config: MatchingConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Downscaled (H_d, W_d) float32 pair -> ``(disparity_down, mbm_costs)``.

    ``disparity_down``: (H_d, W_d) WTA winners in downscaled units,
    including the min-disparity offset.  ``mbm_costs``: (3, H_d, W_d), the
    aggregated cost at (winner - 1, winner, winner + 1) with mod-D wrap.
    """
    if not use_kernel(left_down, "matching_core"):
        return matching_core_plain(left_down, right_down, config)
    c = config
    h, w = left_down.shape[-2:]
    dev = left_down.device
    check_cuda("left_down", left_down, dev, (h, w))
    check_cuda("right_down", right_down, dev, (h, w))
    disparity = torch.empty((h, w), dtype=torch.float32, device=dev)
    mbm = torch.empty((3, h, w), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.stereo_matching_core(
            left_down.data_ptr(), right_down.data_ptr(), disparity.data_ptr(),
            mbm.data_ptr(), h, w, c.min_disparity_down,
            c.num_disparities_down, c.cost_patch_radius, c.small_mbm_radius,
            c.mid_mbm_radius, c.large_mbm_radius, stream)
    build.check(status, "matching_core")
    LAUNCHES["matching_core"] += 1
    return disparity, mbm


def sampled_window_plain(left_gray: torch.Tensor, right_gray: torch.Tensor,
                         disparity_down: torch.Tensor,
                         config: MatchingConfig) -> torch.Tensor:
    """Plain version: the dense stride-k sampled SAD volume over every
    disparity any pixel can ask for, then each pixel's window."""
    c = config
    k = c.k
    num_dense = k * (c.num_disparities_down + 1) + 3
    d_start = k * (c.min_disparity_down - 1) - 1
    dense = sampled_sad_volume(left_gray, right_gray, k, c.sad_patch_radius,
                               d_start, num_dense)
    d_idx = disparity_down.to(torch.int64) - c.min_disparity_down
    window = take_window_lanes(dense, k * d_idx, 2 * k + 3)
    return torch.movedim(window, -1, 0).contiguous()


def sampled_window(left_gray: torch.Tensor, right_gray: torch.Tensor,
                   disparity_down: torch.Tensor,
                   config: MatchingConfig) -> torch.Tensor:
    """Full-res (H, W) float32 pair + (H_d, W_d) WTA winners -> (2k+3, H_d,
    W_d) windows; tap s is the similarity at full-res disparity
    ``k*(d_mbm - 1) - 1 + s`` centred at ``(k*y, k*x)``."""
    if not use_kernel(left_gray, "sampled_window"):
        return sampled_window_plain(left_gray, right_gray, disparity_down,
                                    config)
    c = config
    k = c.k
    h, w = left_gray.shape[-2:]
    hd, wd = -(-h // k), -(-w // k)
    dev = left_gray.device
    check_cuda("left_gray", left_gray, dev, (h, w))
    check_cuda("right_gray", right_gray, dev, (h, w))
    check_cuda("disparity_down", disparity_down, dev, (hd, wd))
    out = torch.empty((2 * k + 3, hd, wd), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.stereo_sampled_window(
            left_gray.data_ptr(), right_gray.data_ptr(),
            disparity_down.data_ptr(), out.data_ptr(), h, w, hd, wd, k,
            c.sad_patch_radius, c.min_disparity_down, stream)
    build.check(status, "sampled_window")
    LAUNCHES["sampled_window"] += 1
    return out
