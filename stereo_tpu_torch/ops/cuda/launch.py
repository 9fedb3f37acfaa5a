"""What every kernel wrapper shares: the launch counts, the CPU/CUDA
dispatch rule and the argument checks before a launch."""

from __future__ import annotations

from typing import Tuple

import torch

# Kernel launches by kernel name; a wrapper adds one where it launches.
LAUNCHES = {"matching_core": 0, "sampled_window": 0, "upsample_blend": 0,
            "gwc_volume": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def use_kernel(t: torch.Tensor, name: str) -> bool:
    """True for the kernel (a CUDA tensor), False for the plain version (a
    CPU tensor); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(message)


def check_cuda(name: str, t: torch.Tensor, device: torch.device,
               shape: Tuple[int, ...],
               dtypes: Tuple[torch.dtype, ...] = (torch.float32,)) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` on ``device``
    with a dtype in ``dtypes`` (float32 unless the kernel says otherwise):
    the only layout the kernels take."""
    require(t.device == device, f"{name} is on {t.device}, expected {device}")
    require(t.dtype in dtypes, f"{name} must be one of {dtypes}, got {t.dtype}")
    require(tuple(t.shape) == tuple(shape),
            f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    require(t.is_contiguous(), f"{name} must be contiguous")
