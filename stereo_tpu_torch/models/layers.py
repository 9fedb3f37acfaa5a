"""Layers of the port's networks (port of the parts of
``stereo_tpu/models/layers.py`` that Deep3D uses)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _parity_taps(s: int) -> np.ndarray:
    """``midx[p, t]``: the two kernel taps of output parity class ``p``,
    whose input offset is ``off[p] = (p >= s // 2)``
    (``stereo_tpu/ops/conv3d.py:150-185``)."""
    off = [1 if p >= s // 2 else 0 for p in range(s)]
    return np.array([[2 * s - 1 - s // 2 - p + s * (off[p] + t - 1)
                      for t in (0, 1)] for p in range(s)])


def pack_parity_weight(w_hwio: torch.Tensor, s: int) -> torch.Tensor:
    """Flax (2s, 2s, C_in, C_out) ConvTranspose kernel -> the (s*s*C_out,
    C_in, 2, 2) weight of the one 2x2 convolution that ``deconv2d_parity``
    runs; output channel ``(p_y * s + p_x) * C_out + c``."""
    kh, kw, cin, cout = w_hwio.shape
    if kh != 2 * s or kw != 2 * s:
        raise ValueError(f"deconv2d_parity needs a (2s,2s) kernel, got "
                         f"{(kh, kw)} for stride {s}")
    idx = torch.as_tensor(_parity_taps(s), device=w_hwio.device)
    wp = w_hwio[idx[:, :, None, None], idx[None, None, :, :]]
    # (p_y, t_y, p_x, t_x, ci, co) -> (p_y, p_x, co, ci, t_y, t_x)
    wp = wp.permute(0, 2, 5, 4, 1, 3)
    return wp.reshape(s * s * cout, cin, 2, 2)


def deconv2d_parity(x_nchw: torch.Tensor, packed: torch.Tensor,
                    s: int) -> torch.Tensor:
    """Flax ``ConvTranspose`` with a (2s, 2s) kernel, stride s and SAME
    padding, which is not torch's ``ConvTranspose2d``: output ``s*j + p``
    sums two taps per axis around input ``j - 1 + off[p]``.  Runs one 2x2
    convolution with ``s*s*C_out`` channels on the input padded by 1, then
    interleaves the parity classes.  ``packed`` comes from
    :func:`pack_parity_weight`."""
    n, _, h, w = x_nchw.shape
    cout = packed.shape[0] // (s * s)
    y = F.conv2d(F.pad(x_nchw, (1, 1, 1, 1)), packed)   # (n, s*s*co, h+1, w+1)
    y = y.reshape(n, s, s, cout, h + 1, w + 1)          # (n, py, px, co, ., .)
    # Class p reads input offset off[p] = (p >= s//2): the first half of
    # the classes takes rows (columns) 0..h-1, the second half 1..h.
    half = s // 2
    y = torch.cat([y[:, :half, :, :, :h], y[:, half:, :, :, 1:]], dim=1)
    y = torch.cat([y[..., :w][:, :, :half], y[..., 1:][:, :, half:]], dim=2)
    out = y.permute(0, 3, 4, 1, 5, 2)                   # (n, co, h, py, w, px)
    return out.reshape(n, cout, s * h, s * w)


class Deconv2dParity(nn.Module):
    """SAME (2s, 2s)/stride-s transposed convolution with Flax semantics.

    ``weight`` keeps the Flax (2s, 2s, C_in, C_out) layout, so checkpoints
    load unchanged; the packed 2x2 weight is rebuilt only when ``weight``
    changes.
    """

    def __init__(self, in_channels: int, out_channels: int, scale: int,
                 bias: bool = True):
        super().__init__()
        self.scale = scale
        k = 2 * scale
        self.weight = nn.Parameter(torch.empty(k, k, in_channels, out_channels))
        nn.init.normal_(self.weight, std=(k * k * in_channels) ** -0.5)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self._packed = None
        self._packed_key = None

    def packed_weight(self) -> torch.Tensor:
        if torch.is_grad_enabled():
            return pack_parity_weight(self.weight, self.scale)
        key = (self.weight.data_ptr(), self.weight._version,
               self.weight.dtype, self.weight.device)
        if key != self._packed_key:
            self._packed = pack_parity_weight(self.weight, self.scale)
            self._packed_key = key
        return self._packed

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = deconv2d_parity(x, self.packed_weight(), self.scale)
        if self.bias is not None:
            out = out + self.bias[:, None, None]
        return out
