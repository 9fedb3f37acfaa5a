"""Per-pixel gathers along the trailing axis
(port of ``stereo_tpu/ops/gather.py``; ``torch.gather`` does the work the
JAX op spells as masked selects)."""

from __future__ import annotations

import torch


def take_window_lanes(volume: torch.Tensor, start: torch.Tensor,
                      width: int) -> torch.Tensor:
    """``out[..., s] = volume[..., start[...] + s]`` for s in [0, width).

    ``start`` is an integer tensor shaped like ``volume.shape[:-1]`` with
    values in ``[0, D - width]``.
    """
    offsets = torch.arange(width, device=volume.device)
    index = start.to(torch.int64)[..., None] + offsets
    return torch.gather(volume, -1, index)


def take_lane(volume: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``out[...] = volume[..., index[...]]``."""
    return torch.gather(volume, -1, index.to(torch.int64)[..., None])[..., 0]
