"""Cost volumes and disparity regression of the DNN stereo backends
(port of ``stereo_tpu/models/cost_volumes.py``).

Feature maps are (N, C, H, W) at 1/4 resolution and volumes (N, C, D, H, W),
the layout ``conv3d`` takes; the JAX package keeps NHWC / NDHWC.  The
group-wise correlation volume is the ``gwc_volume`` kernel on a CUDA
tensor and its plain version on a CPU tensor.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda import gwc_volume


def groupwise_correlation(fa: torch.Tensor, fb: torch.Tensor,
                          num_groups: int) -> torch.Tensor:
    """Per-group mean of elementwise products over the channel axis:
    (N, C, H, W) x2 -> (N, G, H, W)."""
    n, c, h, w = fa.shape
    return (fa * fb).view(n, num_groups, c // num_groups, h, w).mean(2)


# Group-wise correlation volume: (N, C, H, W) x2 -> (N, G, D, H, W), zero
# where w < d (the JAX package's name for it).
build_gwc_volume = gwc_volume


def build_concat_volume(left: torch.Tensor, right: torch.Tensor,
                        max_disparity: int) -> torch.Tensor:
    """Concatenation volume: (N, C, H, W) x2 -> (N, 2C, D, H, W); plane d
    holds left columns d.. beside right columns ..W-d, zero where
    ``w < d``."""
    n, c, h, w = left.shape
    vol = left.new_zeros((n, 2 * c, max_disparity, h, w))
    for d in range(max_disparity):
        vol[:, :c, d, :, d:] = left[..., d:]
        vol[:, c:, d, :, d:] = right[..., :w - d]
    return vol


def interlace(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Interleave channels L0 R0 L1 R1 ...: (N, C, H, W) x2 -> (N, 2C, H, W)."""
    n, c, h, w = left.shape
    return torch.stack([left, right], dim=2).reshape(n, 2 * c, h, w)


def build_interlaced_volume(left: torch.Tensor, right: torch.Tensor,
                            max_disparity: int) -> torch.Tensor:
    """MSNet2D's interlaced volume with disparity folded into channels:
    (N, C, H, W) x2 -> (N, D*2C, H, W), channel block d the interlaced
    pair at disparity d, zero where ``w < d``."""
    w = left.shape[-1]
    return torch.cat([F.pad(interlace(left[..., d:], right[..., :w - d]),
                            (d, 0)) for d in range(max_disparity)], dim=1)


def disparity_regression(prob: torch.Tensor, max_disparity: int) -> torch.Tensor:
    """Soft-argmin: (N, D, H, W) probabilities -> (N, H, W) expected
    disparity."""
    d = torch.arange(max_disparity, dtype=prob.dtype, device=prob.device)
    return torch.einsum("ndhw,d->nhw", prob, d)


def upsampled_soft_argmin(logits: torch.Tensor, out_dhw: Tuple[int, int, int],
                          block: int = 8) -> torch.Tensor:
    """``disparity_regression(softmax(upsample_trilinear(logits)))`` from an
    (N, 1, D_l, H_l, W_l) logit volume, without the full-resolution
    (D, H, W) volume: H and W are resized at low D (bilinear, half-pixel
    centres), then D is expanded ``block`` planes at a time, each plane a
    fixed 2-tap blend of neighbouring low-D planes, folded into a running
    softmax expectation (running max, normaliser and weighted sum).
    Returns (N, H, W) float32."""
    n, c, dl, hl, wl = logits.shape
    if c != 1:
        raise ValueError("regression head expects a single-channel volume")
    D, H, W = (int(v) for v in out_dhw)
    x = F.interpolate(logits[:, 0], size=(H, W), mode="bilinear",
                      align_corners=False).float()          # (N, D_l, H, W)

    # Half-pixel D coordinates, clamped, as jax.image.resize places them.
    in_c = np.clip((np.arange(D) + 0.5) * (dl / D) - 0.5, 0.0, float(dl - 1))
    d0 = np.minimum(in_c.astype(np.int64), max(dl - 2, 0))
    d1 = np.minimum(d0 + 1, dl - 1)
    frac = torch.as_tensor(in_c - d0, dtype=torch.float32, device=x.device)
    idx0 = torch.as_tensor(d0, device=x.device)
    idx1 = torch.as_tensor(d1, device=x.device)
    disp = torch.arange(D, dtype=torch.float32, device=x.device)

    m = x.new_full((n, H, W), -1e30)
    s = x.new_zeros((n, H, W))
    acc = x.new_zeros((n, H, W))
    for start in range(0, D, block):
        sl = slice(start, min(start + block, D))
        f = frac[sl, None, None]
        planes = (1.0 - f) * x[:, idx0[sl]] + f * x[:, idx1[sl]]
        m_blk = planes.amax(dim=1)
        e = torch.exp(planes - m_blk[:, None])
        m_new = torch.maximum(m, m_blk)
        scale_old = torch.exp(m - m_new)
        scale_blk = torch.exp(m_blk - m_new)
        s = s * scale_old + e.sum(1) * scale_blk
        acc = acc * scale_old + torch.einsum("nbhw,b->nhw", e,
                                             disp[sl]) * scale_blk
        m = m_new
    return acc / s
