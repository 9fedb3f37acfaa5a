"""Layers of the port's networks (port of ``stereo_tpu/models/layers.py``).

Submodules carry the Flax module names (``Conv_0``, ``BatchNorm_0``, ...)
so the committed Flax checkpoints map onto ``state_dict`` keys by name
(``models.stereo_state_dict_from_flax``).  Tensors are NCHW / NCDHW.
Convolutions pad as Flax's SAME does (``ops.conv3d.same_padding``).
BatchNorm follows ``module.training``: batch statistics and Flax's update
of the running ones in training, the running statistics in eval.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3d import conv_same, deconv3d_parity, pack_deconv3d_weight
from ..ops import rows


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
    x, pads = rows.take_halo(x_nchw, [(1, 1)] * 2)
    y = F.conv2d(F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi]),
                 packed)                            # (n, s*s*co, h+1, w+1)
    y = y.reshape(n, s, s, cout, h + 1, w + 1)          # (n, py, px, co, ., .)
    # Class p reads input offset off[p] = (p >= s//2): the first half of
    # the classes takes rows (columns) 0..h-1, the second half 1..h.
    half = s // 2
    y = torch.cat([y[:, :half, :, :, :h], y[:, half:, :, :, 1:]], dim=1)
    y = torch.cat([y[..., :w][:, :, :half], y[..., 1:][:, :, half:]], dim=2)
    out = y.permute(0, 3, 4, 1, 5, 2)                   # (n, co, h, py, w, px)
    return out.reshape(n, cout, s * h, s * w)


class _PackedDeconv(nn.Module):
    """A transposed convolution whose ``weight`` keeps the Flax (k, ..., k,
    C_in, C_out) layout, so checkpoints load unchanged, and runs as one
    convolution with the weight its subclass's ``pack`` makes; the packed
    weight is rebuilt only when ``weight`` changes."""

    def __init__(self, kernel: Tuple[int, ...], in_channels: int,
                 out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*kernel, in_channels,
                                               out_channels))
        nn.init.normal_(self.weight,
                        std=(int(np.prod(kernel)) * in_channels) ** -0.5)
        self._packed = None
        self._packed_key = None

    def packed_weight(self) -> torch.Tensor:
        if torch.is_grad_enabled():
            return self.pack(self.weight)
        key = (self.weight.data_ptr(), self.weight._version,
               self.weight.dtype, self.weight.device)
        if key != self._packed_key:
            self._packed = self.pack(self.weight)
            self._packed_key = key
        return self._packed


class Deconv2dParity(_PackedDeconv):
    """SAME (2s, 2s)/stride-s transposed convolution with Flax semantics."""

    def __init__(self, in_channels: int, out_channels: int, scale: int,
                 bias: bool = True):
        super().__init__((2 * scale, 2 * scale), in_channels, out_channels)
        self.scale = scale
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def pack(self, weight: torch.Tensor) -> torch.Tensor:
        return pack_parity_weight(weight, self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = deconv2d_parity(x, self.packed_weight(), self.scale)
        if self.bias is not None:
            out = out + self.bias[:, None, None]
        return out


class Deconv3dParity(_PackedDeconv):
    """SAME (4,4,4)/stride-2 transposed convolution with Flax semantics
    (``ops.conv3d.deconv3d_parity``), without bias."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__((4, 4, 4), in_channels, out_channels)

    def pack(self, weight: torch.Tensor) -> torch.Tensor:
        return pack_deconv3d_weight(weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return deconv3d_parity(x, self.packed_weight())


class Conv(nn.Module):
    """Flax ``nn.Conv`` with SAME padding, 2-D or 3-D by the rank of
    ``kernel``; ``groups=C`` is Flax's ``feature_group_count=C``.  It also
    stands for ``Conv3dMXU``, which computes the same convolution."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int], stride: int = 1, dilation: int = 1,
                 groups: int = 1, bias: bool = False):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *kernel))
        nn.init.normal_(self.weight, std=(self.weight[0].numel()) ** -0.5)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_same(x, self.weight, self.bias, self.stride,
                         self.dilation, self.groups)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over axis 1 (eps 1e-5, momentum 0.99): scale
    and bias are ``weight`` and ``bias``, the running statistics
    ``running_mean`` and ``running_var``.

    Eval mode (Flax's ``use_running_average=True``) normalises with the
    running statistics.  Training mode normalises with the batch's mean
    and its biased variance, taken as Flax does (``mean(x^2) - mean(x)^2``,
    clipped at 0), and updates the running statistics with Flax's rule
    ``0.99 * running + 0.01 * batch``, written out: torch's own update
    would store the unbiased variance."""

    eps = 1e-5
    momentum = 0.99

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = [0] + list(range(2, x.dim()))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dims)
        var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(self.momentum * self.running_mean
                                    + (1.0 - self.momentum) * mean)
            self.running_var.copy_(self.momentum * self.running_var
                                   + (1.0 - self.momentum) * var)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class ConvBnAct(nn.Module):
    """Conv -> BatchNorm -> optional ReLU (2-D or 3-D by kernel rank)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int] = (3, 3), stride: int = 1,
                 dilation: int = 1, act: bool = True):
        super().__init__()
        self.act = act
        self.Conv_0 = Conv(in_channels, out_channels, kernel, stride, dilation)
        self.BatchNorm_0 = BatchNorm(out_channels)

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.act else x


class BasicResBlock(nn.Module):
    """Two 3x3 conv-bn layers with an identity or projected skip (GwcNet's
    feature-extractor residual unit)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.stride = stride
        self.ConvBnAct_0 = ConvBnAct(in_channels, features, (3, 3), stride,
                                     dilation)
        self.ConvBnAct_1 = ConvBnAct(features, features, (3, 3), 1, dilation,
                                     act=False)
        self.project = stride != 1 or in_channels != features
        if self.project:
            self.Conv_0 = Conv(in_channels, features, (1, 1), stride)
            self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        out = self.ConvBnAct_1(self.ConvBnAct_0(x))
        identity = self.BatchNorm_0(self.Conv_0(x)) if self.project else x
        return F.relu(out + identity)


class SeparableConvBn2D(nn.Module):
    """Depthwise 3x3 + pointwise 1x1 (MobileStereoNet's 2-D separable
    conv)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 dilation: int = 1, act: bool = True):
        super().__init__()
        self.act = act
        self.Conv_0 = Conv(in_channels, in_channels, (3, 3), stride, dilation,
                           groups=in_channels)
        self.BatchNorm_0 = BatchNorm(in_channels)
        self.Conv_1 = Conv(in_channels, features, (1, 1))
        self.BatchNorm_1 = BatchNorm(features)

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        x = self.BatchNorm_1(self.Conv_1(x))
        return F.relu(x) if self.act else x


class _MobileV2Block(nn.Module):
    """Inverted-residual bottleneck (MobileNetV2): expand 1x1 -> depthwise
    3x3 -> project 1x1, with a residual when the stride is 1 and the
    channels match; ``rank`` 2 or 3."""

    def __init__(self, rank: int, in_channels: int, features: int,
                 stride: int = 1, expansion: int = 2, dilation: int = 1):
        super().__init__()
        hidden = in_channels * expansion
        self.stride = stride
        self.residual = stride == 1 and in_channels == features
        self.Conv_0 = Conv(in_channels, hidden, (1,) * rank)
        self.BatchNorm_0 = BatchNorm(hidden)
        self.Conv_1 = Conv(hidden, hidden, (3,) * rank, stride, dilation,
                           groups=hidden)
        self.BatchNorm_1 = BatchNorm(hidden)
        self.Conv_2 = Conv(hidden, features, (1,) * rank)
        self.BatchNorm_2 = BatchNorm(features)

    def forward(self, x):
        out = F.relu6(self.BatchNorm_0(self.Conv_0(x)))
        out = F.relu6(self.BatchNorm_1(self.Conv_1(out)))
        out = self.BatchNorm_2(self.Conv_2(out))
        return out + x if self.residual else out


class MobileV2Block2D(_MobileV2Block):
    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 expansion: int = 2, dilation: int = 1):
        super().__init__(2, in_channels, features, stride, expansion, dilation)


class MobileV2Block3D(_MobileV2Block):
    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 expansion: int = 2):
        super().__init__(3, in_channels, features, stride, expansion)


class DeconvBn(nn.Module):
    """x2 transposed conv + BN: 2-D through ``Deconv2dParity`` (4x4,
    stride 2, no bias), 3-D through ``Deconv3dParity``."""

    def __init__(self, in_channels: int, features: int, rank: int):
        super().__init__()
        self.ConvTranspose_0 = (
            Deconv2dParity(in_channels, features, 2, bias=False) if rank == 2
            else Deconv3dParity(in_channels, features))
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        return self.BatchNorm_0(self.ConvTranspose_0(x))


def upsample_trilinear(x: torch.Tensor, shape: Tuple[int, int, int]
                       ) -> torch.Tensor:
    """Trilinear resize (half-pixel centres) of an (N, C, D, H, W) volume
    to (D', H', W') (``ops.rows.interpolate``: inside a row split it
    reads one row of each neighbouring shard)."""
    return rows.interpolate(x, shape, "trilinear")
