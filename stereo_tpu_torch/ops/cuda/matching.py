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
from .launch import (check_cuda, count_launch, refuse_autograd, require,
                     use_kernel)


def _row_pads(config: MatchingConfig, rows_prepadded: bool):
    """The extra rows above and below the inputs of ``matching_core`` and
    of ``sampled_window`` in the row-halo mode (``rows_prepadded``), as the
    TPU kernels take them: ``large_mbm_radius + cost_patch_radius`` and
    ``sad_patch_radius``; ``(0, 0)`` otherwise.  The first covers the
    aggregation's reach only when the large radius is the largest."""
    c = config
    if not rows_prepadded:
        return 0, 0
    if c.large_mbm_radius < max(c.small_mbm_radius, c.mid_mbm_radius):
        raise ValueError("rows_prepadded needs large_mbm_radius >= the small "
                         "and mid radii (the halo is large + cost radius)")
    return c.large_mbm_radius + c.cost_patch_radius, c.sad_patch_radius


def matching_core_plain(left_down: torch.Tensor, right_down: torch.Tensor,
                        config: MatchingConfig, rows_prepadded: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: materialized cost volume, aggregation, first-max WTA
    and the aggregate at (winner - 1, winner, winner + 1) mod D."""
    c = config
    _row_pads(c, rows_prepadded)
    volume = sad_cost_volume(left_down, right_down, c.min_disparity_down,
                             c.max_disparity_down, c.cost_patch_radius,
                             rows_prepadded=rows_prepadded)
    aggregated = mbm_aggregate(volume, c.small_mbm_radius, c.mid_mbm_radius,
                               c.large_mbm_radius,
                               rows_prepadded=rows_prepadded)
    disparity = wta_disparity(aggregated, c.min_disparity_down)
    num_d = aggregated.shape[-1]
    d_idx = disparity.to(torch.int64) - c.min_disparity_down
    mbm = torch.stack([take_lane(aggregated, torch.remainder(d_idx + j, num_d))
                       for j in (-1, 0, 1)])
    return disparity, mbm


def matching_core(left_down: torch.Tensor, right_down: torch.Tensor,
                  config: MatchingConfig, rows_prepadded: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Downscaled (H_d, W_d) float32 pair -> ``(disparity_down, mbm_costs)``.

    ``disparity_down``: (H_d, W_d) WTA winners in downscaled units,
    including the min-disparity offset.  ``mbm_costs``: (3, H_d, W_d), the
    aggregated cost at (winner - 1, winner, winner + 1) with mod-D wrap.

    With ``rows_prepadded`` (the row-halo mode of a row shard) the inputs
    are (H_d + 2 * (large_mbm_radius + cost_patch_radius), W_d): the extra
    rows above and below come from the neighbouring shards and do not
    wrap; only the columns wrap.
    """
    if not use_kernel(left_down, "matching_core"):
        return matching_core_plain(left_down, right_down, config,
                                   rows_prepadded)
    refuse_autograd("matching_core", left_down, right_down)
    c = config
    pad, _ = _row_pads(c, rows_prepadded)
    h_in, w = left_down.shape[-2:]
    h = h_in - 2 * pad
    require(h > 0, f"matching_core: {h_in} rows cannot hold a {pad}-row halo")
    dev = left_down.device
    check_cuda("left_down", left_down, dev, (h_in, w))
    check_cuda("right_down", right_down, dev, (h_in, w))
    disparity = torch.empty((h, w), dtype=torch.float32, device=dev)
    mbm = torch.empty((3, h, w), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.stereo_matching_core(
            left_down.data_ptr(), right_down.data_ptr(), disparity.data_ptr(),
            mbm.data_ptr(), h, w, c.min_disparity_down,
            c.num_disparities_down, c.cost_patch_radius, c.small_mbm_radius,
            c.mid_mbm_radius, c.large_mbm_radius, pad, stream)
    build.check(status, "matching_core")
    count_launch("matching_core")
    if pad:
        count_launch("matching_core[rows_prepadded]")
    return disparity, mbm


def sampled_window_plain(left_gray: torch.Tensor, right_gray: torch.Tensor,
                         disparity_down: torch.Tensor, config: MatchingConfig,
                         rows_prepadded: bool = False) -> torch.Tensor:
    """Plain version: the dense stride-k sampled SAD volume over every
    disparity any pixel can ask for, then each pixel's window."""
    c = config
    k = c.k
    _row_pads(c, rows_prepadded)
    num_dense = k * (c.num_disparities_down + 1) + 3
    d_start = k * (c.min_disparity_down - 1) - 1
    dense = sampled_sad_volume(left_gray, right_gray, k, c.sad_patch_radius,
                               d_start, num_dense,
                               rows_prepadded=rows_prepadded)
    d_idx = disparity_down.to(torch.int64) - c.min_disparity_down
    window = take_window_lanes(dense, k * d_idx, 2 * k + 3)
    return torch.movedim(window, -1, 0).contiguous()


def sampled_window(left_gray: torch.Tensor, right_gray: torch.Tensor,
                   disparity_down: torch.Tensor, config: MatchingConfig,
                   rows_prepadded: bool = False) -> torch.Tensor:
    """Full-res (H, W) float32 pair + (H_d, W_d) WTA winners -> (2k+3, H_d,
    W_d) windows; tap s is the similarity at full-res disparity
    ``k*(d_mbm - 1) - 1 + s`` centred at ``(k*y, k*x)``.

    With ``rows_prepadded`` the images are (k * H_d + 2 * sad_patch_radius,
    W): the extra rows above and below come from the neighbouring shards
    and do not wrap; only the columns wrap."""
    if not use_kernel(left_gray, "sampled_window"):
        return sampled_window_plain(left_gray, right_gray, disparity_down,
                                    config, rows_prepadded)
    refuse_autograd("sampled_window", left_gray, right_gray, disparity_down)
    c = config
    k = c.k
    _, pad = _row_pads(c, rows_prepadded)
    h_in, w = left_gray.shape[-2:]
    h = h_in - 2 * pad
    hd, wd = -(-h // k), -(-w // k)
    require(h > 0 and (pad == 0 or h % k == 0),
            f"sampled_window: {h_in} rows less the {pad}-row halo are not "
            f"a positive multiple of k={k}")
    dev = left_gray.device
    check_cuda("left_gray", left_gray, dev, (h_in, w))
    check_cuda("right_gray", right_gray, dev, (h_in, w))
    check_cuda("disparity_down", disparity_down, dev, (hd, wd))
    out = torch.empty((2 * k + 3, hd, wd), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.stereo_sampled_window(
            left_gray.data_ptr(), right_gray.data_ptr(),
            disparity_down.data_ptr(), out.data_ptr(), h, w, hd, wd, k,
            c.sad_patch_radius, c.min_disparity_down, c.num_disparities_down,
            pad, stream)
    build.check(status, "sampled_window")
    count_launch("sampled_window")
    if pad:
        count_launch("sampled_window[rows_prepadded]")
    return out
