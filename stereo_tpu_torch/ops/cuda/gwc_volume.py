"""Wrapper of the ``gwc_volume`` kernel (GwcNet's group-wise correlation
volume) with its plain PyTorch version."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build
from .launch import LAUNCHES, check_cuda, require, use_kernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_CPG = 8   # channels per group the kernel is built for (GwcNet: 320 / 40)


def gwc_volume_plain(left: torch.Tensor, right: torch.Tensor,
                     max_disparity: int, num_groups: int) -> torch.Tensor:
    """Plain version, a transcription of the JAX build: the right map
    padded by ``max_disparity`` zero columns on the left feeds every plane
    as a slice, and each group's channel mean is a reshape and ``mean``.
    Products and means are taken in float32 and the volume is returned in
    the features' dtype."""
    n, c, h, w = left.shape
    lf, rp = left.float(), F.pad(right.float(), (max_disparity, 0))
    planes = [(lf * rp[..., max_disparity - d:max_disparity - d + w])
              .view(n, num_groups, c // num_groups, h, w).mean(2)
              for d in range(max_disparity)]
    return torch.stack(planes, dim=2).to(left.dtype)


def gwc_volume(left: torch.Tensor, right: torch.Tensor, max_disparity: int,
               num_groups: int) -> torch.Tensor:
    """(N, C, H, W) left/right features -> (N, G, D, H, W) volume,
    ``vol[n, g, d, h, w] = mean_{c in g} L[n, c, h, w] * R[n, c, h, w - d]``
    and 0 where ``w < d``; float32 or bf16, in the features' dtype."""
    n, c, h, w = left.shape
    require(right.shape == left.shape,
            f"right {tuple(right.shape)} differs from left {tuple(left.shape)}")
    require(num_groups > 0 and c % num_groups == 0,
            f"{c} channels do not split into {num_groups} groups")
    require(max_disparity > 0, f"max_disparity must be positive, got "
                               f"{max_disparity}")
    if not use_kernel(left, "gwc_volume"):
        return gwc_volume_plain(left, right, max_disparity, num_groups)
    dev = left.device
    dtypes = tuple(_DTYPE_CODES)
    check_cuda("left", left, dev, (n, c, h, w), dtypes)
    check_cuda("right", right, dev, (n, c, h, w), (left.dtype,))
    require(c // num_groups == _KERNEL_CPG,
            f"gwc_volume kernel takes {_KERNEL_CPG} channels per group, "
            f"got {c // num_groups}")
    out = torch.empty((n, num_groups, max_disparity, h, w), dtype=left.dtype,
                      device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.stereo_gwc_volume(
            left.data_ptr(), right.data_ptr(), out.data_ptr(), n, c, h, w,
            num_groups, max_disparity, _DTYPE_CODES[left.dtype], stream)
    build.check(status, "gwc_volume")
    LAUNCHES["gwc_volume"] += 1
    return out
