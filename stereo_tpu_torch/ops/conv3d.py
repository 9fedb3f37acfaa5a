"""Convolutions with Flax semantics (port of ``stereo_tpu/ops/conv3d.py``).

``stereo_tpu/ops/conv3d.py`` rewrites one plain 3-D convolution in several
ways (``conv3d_mxu``, ``_chunked``, ``_shiftadd``) to fill the TPU's matrix
unit; they all compute ``conv3d_native``.  The port has one function for
it, :func:`conv_same`, a cuDNN convolution with Flax's SAME padding, for
2-D and 3-D kernels alike.  :func:`deconv3d_parity` transcribes the
(4,4,4)/stride-2 SAME transposed convolution of Flax's ``ConvTranspose``,
which is not torch's ``ConvTranspose3d``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

_CONV = {4: F.conv2d, 5: F.conv3d}


def same_padding(sizes: Sequence[int], kernel: Sequence[int], stride: int,
                 dilation: int) -> List[Tuple[int, int]]:
    """Flax/XLA SAME padding ``(low, high)`` per spatial axis: the output
    has ``ceil(size / stride)`` positions and the total padding, split with
    the extra element on the high side, is whatever that needs.  With
    stride 2 on an even size and a 3-wide kernel this is (0, 1), not the
    (1, 1) of torch's ``padding=1``."""
    pads = []
    for size, k in zip(sizes, kernel):
        out = -(-size // stride)
        total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def conv_same(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None, stride: int = 1,
              dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """N(C)HW / N(C)DHW convolution with Flax SAME padding and isotropic
    stride and dilation; ``weight`` is torch's (O, I/groups, *kernel)."""
    pads = same_padding(x.shape[2:], weight.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pads):
        padding = tuple(lo for lo, _ in pads)
    else:
        x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
        padding = 0
    return _CONV[x.dim()](x, weight, bias, stride, padding, dilation, groups)


def pack_deconv3d_weight(w: torch.Tensor) -> torch.Tensor:
    """Flax (4, 4, 4, C_in, C_out) ``ConvTranspose`` kernel -> the
    (8 * C_out, C_in, 2, 2, 2) weight of the one (2,2,2) convolution that
    :func:`deconv3d_parity` runs; output channel
    ``((p_z * 2 + p_y) * 2 + p_x) * C_out + c`` holds parity class p."""
    kd, kh, kw, cin, cout = w.shape
    if (kd, kh, kw) != (4, 4, 4):
        raise ValueError(f"deconv3d_parity needs a (4,4,4) kernel, got "
                         f"{(kd, kh, kw)}")
    # Kernel index 2 t + p: (t_z, p_z, t_y, p_y, t_x, p_x, ci, co).
    wp = w.reshape(2, 2, 2, 2, 2, 2, cin, cout)
    wp = wp.permute(1, 3, 5, 7, 6, 0, 2, 4)     # (pz, py, px, co, ci, tz, ty, tx)
    return wp.reshape(8 * cout, cin, 2, 2, 2)


def deconv3d_parity(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Flax ``ConvTranspose`` with a (4,4,4) kernel, stride 2 and SAME
    padding, on an (N, C, D, H, W) volume: output ``2 j + p`` sums taps
    ``w[2 t + p]`` over input ``j - 1 + p + t`` on each axis.  Runs one
    (2,2,2) convolution with ``8 * C_out`` channels on the input padded by
    1, then interleaves the parity classes.  ``packed`` comes from
    :func:`pack_deconv3d_weight`."""
    n, _, d, h, w = x.shape
    cout = packed.shape[0] // 8
    y = F.conv3d(F.pad(x, (1, 1, 1, 1, 1, 1)), packed)  # (n, 8co, d+1, h+1, w+1)
    y = y.reshape(n, 2, 2, 2, cout, d + 1, h + 1, w + 1)
    # Class p = 0 reads positions 0..size-1 of its axis, class 1 reads 1..size.
    y = torch.cat([y[:, :1, :, :, :, :d], y[:, 1:, :, :, :, 1:]], dim=1)
    y = torch.cat([y[:, :, :1, :, :, :, :h], y[:, :, 1:, :, :, :, 1:]], dim=2)
    y = torch.cat([y[:, :, :, :1, ..., :w], y[:, :, :, 1:, ..., 1:]], dim=3)
    out = y.permute(0, 4, 5, 1, 6, 2, 7, 3)    # (n, co, d, pz, h, py, w, px)
    return out.reshape(n, cout, 2 * d, 2 * h, 2 * w)
