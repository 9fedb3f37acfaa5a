"""Wrapper of the ``upsample_blend`` kernel (Deep3D's view-synthesis tail)
with its plain PyTorch version."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..shift_stack import weighted_shift_sum
from . import build
from .launch import LAUNCHES, check_cuda, require, use_kernel


def upsample_blend_plain(prob_low_ndhw: torch.Tensor, view_nchw: torch.Tensor,
                         scale: int) -> torch.Tensor:
    """Plain version: bilinear upsample (align_corners=False) of the volume
    to the view's size, then the shifted-view blend."""
    h, w = view_nchw.shape[-2:]
    prob = F.interpolate(prob_low_ndhw, size=(h, w), mode="bilinear",
                         align_corners=False)
    return weighted_shift_sum(prob, view_nchw)


def upsample_blend(prob_low_ndhw: torch.Tensor, view_nchw: torch.Tensor,
                   scale: int) -> torch.Tensor:
    """``resize(prob, x scale, bilinear)`` fused with ``weighted_shift_sum``.

    ``prob_low``: (N, D, H/scale, W/scale) float32 softmax disparity
    probabilities; ``view``: (N, 3, H, W) float32 left views.  Returns the
    synthesized right views (N, 3, H, W).
    """
    n, num_d, hl, wl = prob_low_ndhw.shape
    require(view_nchw.shape == (n, 3, scale * hl, scale * wl),
             f"view shape {tuple(view_nchw.shape)} does not match prob "
             f"{tuple(prob_low_ndhw.shape)} at scale {scale}")
    if not use_kernel(prob_low_ndhw, "upsample_blend"):
        return upsample_blend_plain(prob_low_ndhw, view_nchw, scale)
    h, w = scale * hl, scale * wl
    dev = prob_low_ndhw.device
    check_cuda("prob_low", prob_low_ndhw, dev, (n, num_d, hl, wl))
    check_cuda("view", view_nchw, dev, (n, 3, h, w))
    out = torch.empty((n, 3, h, w), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.stereo_upsample_blend(
            prob_low_ndhw.data_ptr(), view_nchw.data_ptr(), out.data_ptr(),
            n, num_d, hl, wl, h, w, stream)
    build.check(status, "upsample_blend")
    LAUNCHES["upsample_blend"] += 1
    return out
