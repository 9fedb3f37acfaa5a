"""Classical multi-block-matching stereo engine
(port of ``stereo_tpu/matching/classical.py``).

Stage order and units (reference ``csrc/depth/stereo_matching.cc:45-114``):
grayscale, mean-pool by ``k``, inverted-SAD cost volume over ``[min/k,
max/k]``, MBM aggregation, WTA, secondary matching at full resolution,
upscale + vertical fill, horizontal fill -> (H, W) disparity in full-res
units.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import ops
from ..core.config import MatchingConfig
from ..core.device import resolve_device
from ..ops import classical_fused


def compute_disparity_map(left_rgb: torch.Tensor, right_rgb: torch.Tensor,
                          config: MatchingConfig) -> torch.Tensor:
    """(3, H, W) float RGB pair (0..255) -> (H, W) float disparity map."""
    left_gray = ops.rgb_to_grayscale(left_rgb)
    right_gray = ops.rgb_to_grayscale(right_rgb)
    return compute_disparity_from_grayscale(left_gray, right_gray, config)


def compute_disparity_from_grayscale(left_gray: torch.Tensor,
                                     right_gray: torch.Tensor,
                                     config: MatchingConfig) -> torch.Tensor:
    """Stages 2-8 on (H, W) grayscale images.

    ``impl="auto"`` and ``"cuda"`` go through ``ops.classical_fused`` (the
    CUDA kernels on CUDA tensors, their plain versions on CPU tensors);
    ``impl="torch"`` runs the plain composition with the materialized cost
    volume on any device.
    """
    c = config
    if c.impl == "cuda" and left_gray.device.type != "cuda":
        raise ValueError("MatchingConfig(impl='cuda') needs CUDA tensors, got "
                         f"{left_gray.device}")
    if c.impl in ("auto", "cuda"):
        return classical_fused.compute_disparity_from_grayscale(
            left_gray, right_gray, c)

    left_down = ops.mean_pool(left_gray, c.k)
    right_down = ops.mean_pool(right_gray, c.k)
    volume = ops.sad_cost_volume(left_down, right_down, c.min_disparity_down,
                                 c.max_disparity_down, c.cost_patch_radius)
    aggregated = ops.mbm_aggregate(volume, c.small_mbm_radius,
                                   c.mid_mbm_radius, c.large_mbm_radius)
    disparity_down = ops.wta_disparity(aggregated, c.min_disparity_down)
    refined = ops.secondary_matching(left_gray, right_gray, aggregated,
                                     disparity_down, c.k, c.sad_patch_radius,
                                     c.min_disparity_down)
    vfilled = ops.upscale_vertical_fill(left_gray, refined, c.k,
                                        float(c.threshold))
    return ops.horizontal_fill(left_gray, vfilled, c.k, float(c.threshold))


class ClassicalStereoEngine:
    """The classical matcher for a fixed config on one device.

    ``device`` defaults to ``"cuda"`` and raises when CUDA is unavailable;
    pass ``device="cpu"`` for the plain versions on the CPU.
    """

    def __init__(self, config: MatchingConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)

    def _as_tensor(self, image) -> torch.Tensor:
        if isinstance(image, np.ndarray):
            image = torch.from_numpy(image)
        return image.to(self.device, torch.float32)

    def compute_disparity_map(self, left_rgb, right_rgb) -> torch.Tensor:
        """Single (3, H, W) pair -> (H, W) disparity."""
        h, w = left_rgb.shape[-2:]
        if (h, w) != (self.config.height, self.config.width):
            raise ValueError(
                f"engine built for {(self.config.height, self.config.width)}, "
                f"got image of shape {(h, w)}")
        with torch.no_grad():
            return compute_disparity_map(self._as_tensor(left_rgb),
                                         self._as_tensor(right_rgb),
                                         self.config)

    def compute_disparity_maps(self, left_batch, right_batch) -> torch.Tensor:
        """Batched (N, 3, H, W) pairs -> (N, H, W) disparities, one frame at
        a time: one 384x1280 frame already fills the card."""
        lefts = self._as_tensor(left_batch)
        rights = self._as_tensor(right_batch)
        return torch.stack([self.compute_disparity_map(l, r)
                            for l, r in zip(lefts, rights)])

    def warmup(self) -> None:
        """One frame of zeros through the matcher, so that the kernels are
        built before the first real frame (the JAX engine compiles)."""
        x = torch.zeros((3, self.config.height, self.config.width),
                        device=self.device)
        self.compute_disparity_map(x, x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
