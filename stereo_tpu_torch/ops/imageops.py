"""Image-space primitives: grayscale, mean-pool, view rescale.

PyTorch port of ``stereo_tpu/ops/imageops.py``.  All functions operate on
float32 tensors in 0..255 (CHW for color) and keep the reference's exact
arithmetic order, so integer-valued inputs give bit-identical results.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# ITU-R 601 luma weights (csrc/imageops/kernels/rgb_to_grayscale.cu:24-28).
_R, _G, _B = 0.2989, 0.5870, 0.1140


def rgb_to_grayscale(image_chw: torch.Tensor) -> torch.Tensor:
    """(3, H, W) float -> (H, W) float luma, summed as ``(R + G) + B``."""
    r = _R * image_chw[0]
    g = _G * image_chw[1]
    b = _B * image_chw[2]
    return (r + g) + b


def mean_pool(image: torch.Tensor, k: int) -> torch.Tensor:
    """k x k mean pooling with ceil-div output dims, edge-replicated for
    dims not divisible by ``k``.  Explicit adds (rows first, then columns,
    each in index order) fix the arithmetic order, as in the JAX op."""
    if k == 1:
        return image
    h, w = image.shape[-2:]
    oh, ow = -(-h // k), -(-w // k)
    ph, pw = oh * k - h, ow * k - w
    if ph or pw:
        lead = image.shape[:-2]
        image = F.pad(image.reshape(1, -1, h, w), (0, pw, 0, ph),
                      mode="replicate").reshape(*lead, oh * k, ow * k)
    w2 = image.shape[-1]
    rows = image.reshape(*image.shape[:-2], oh, k, w2)
    racc = rows[..., 0, :]
    for i in range(1, k):
        racc = racc + rows[..., i, :]
    acc = racc[..., 0::k]
    for j in range(1, k):
        acc = acc + racc[..., j::k]
    return acc / float(k * k)


def grayscale_gradient(image_hw: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude (``csrc/imageops/grayscale_gradient.cc:8-20``):
    two 3x3 correlations with zero 'same' padding, then
    ``sqrt(gx^2 + gy^2)``."""
    kx = torch.tensor([[1.0, 0.0, -1.0], [2.0, 0.0, -2.0], [1.0, 0.0, -1.0]],
                      dtype=image_hw.dtype, device=image_hw.device)
    img = image_hw[None, None]
    gx = F.conv2d(img, kx[None, None], padding=1)[0, 0]
    gy = F.conv2d(img, kx.T[None, None], padding=1)[0, 0]
    return torch.sqrt(gx * gx + gy * gy)


def rescale_generated_view(view_chw: torch.Tensor) -> torch.Tensor:
    """Map a 0..1 synthesized view to 0..255: ``clip(v * 255 + 0.5)`` with
    no rounding (``csrc/synthesis/kernels/rescale_generated_view.cu:17-18``)."""
    return torch.clamp(view_chw * 255.0 + 0.5, 0.0, 255.0)
