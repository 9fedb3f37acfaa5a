"""MobileStereoNet, MSNet2D and MSNet3D (Shamsafar et al., WACV 2022)
(port of ``stereo_tpu/models/msnet.py``, inference).

A MobileNetV2-style siamese extractor (1/4 resolution, 320 channels)
compressed to 32 channels; MSNet2D builds the interlaced volume, encoding
each disparity's interleaved pair to one score channel, and aggregates in
2-D separable convolutions; MSNet3D builds a concatenation volume and
aggregates in 3-D inverted-residual blocks.  Both regress with the
streaming soft-argmin.  The heads of all three hourglasses are built so
the committed checkpoints load with ``strict=True``; inference runs the
last.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .cost_volumes import (build_concat_volume, interlace,
                           upsampled_soft_argmin)
from .layers import (Conv, ConvBnAct, DeconvBn, MobileV2Block2D,
                     MobileV2Block3D, SeparableConvBn2D)


class MobileFeatureExtractor(nn.Module):
    """Siamese MobileNetV2-style extractor -> (N, 320, H/4, W/4)."""

    def __init__(self, base_channels: int = 32):
        super().__init__()
        c = base_channels
        self.ConvBnAct_0 = ConvBnAct(3, c, (3, 3), 2)
        self.SeparableConvBn2D_0 = SeparableConvBn2D(c, c)
        # (in, out, stride, dilation) of each block: three at 1/2, six at
        # 1/4 (the first strided), three wider, three dilated.
        specs = ([(c, c, 1, 1)] * 3 + [(c, 2 * c, 2, 1)]
                 + [(2 * c, 2 * c, 1, 1)] * 5 + [(2 * c, 4 * c, 1, 1)]
                 + [(4 * c, 4 * c, 1, 1)] * 2 + [(4 * c, 4 * c, 1, 2)] * 3)
        for i, (cin, cout, stride, dilation) in enumerate(specs):
            self.add_module(f"MobileV2Block2D_{i}", MobileV2Block2D(
                cin, cout, stride, dilation=dilation))
        self.num_blocks = len(specs)

    def forward(self, x):
        x = self.SeparableConvBn2D_0(self.ConvBnAct_0(x))
        outs = []
        for i in range(self.num_blocks):
            x = getattr(self, f"MobileV2Block2D_{i}")(x)
            if i in (8, 11, 14):
                outs.append(x)
        return torch.cat(outs, dim=1)                # 64 + 128 + 128


class FeatureCompressor(nn.Module):
    """320 -> 32 channel compression before the volume."""

    def __init__(self, in_channels: int = 320, out_channels: int = 32):
        super().__init__()
        self.ConvBnAct_0 = ConvBnAct(in_channels, 128, (3, 3))
        self.ConvBnAct_1 = ConvBnAct(128, 64, (1, 1))
        self.Conv_0 = Conv(64, out_channels, (1, 1), bias=True)

    def forward(self, x):
        return self.Conv_0(self.ConvBnAct_1(self.ConvBnAct_0(x)))


class InterlacedVolume2D(nn.Module):
    """MSNet2D's volume: for each disparity d, the pair cropped to its
    overlap (left columns d.., right ..W-d) with channels interleaved
    L0 R0 L1 R1 ..., encoded by a shared separable-conv head to one score
    channel, then padded by d zero columns on the left -> (N, D, H, W).
    The encoder sees the cropped width, so its SAME borders are those of
    the crop."""

    def __init__(self, max_disparity: int, channels: int = 32):
        super().__init__()
        self.max_disparity = max_disparity
        self.SeparableConvBn2D_0 = SeparableConvBn2D(2 * channels, 16)
        self.SeparableConvBn2D_1 = SeparableConvBn2D(16, 8)
        self.Conv_0 = Conv(8, 1, (3, 3), bias=True)

    def forward(self, left, right):
        w = left.shape[-1]
        scores = []
        for d in range(self.max_disparity):
            s = interlace(left[..., d:], right[..., :w - d])
            s = self.Conv_0(self.SeparableConvBn2D_1(
                self.SeparableConvBn2D_0(s)))
            scores.append(F.pad(s, (d, 0)))
        return torch.cat(scores, dim=1)


class Hourglass2D(nn.Module):
    """2-D encoder-decoder over the disparity-as-channels volume."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.SeparableConvBn2D_0 = SeparableConvBn2D(c, 2 * c, stride=2)
        self.SeparableConvBn2D_1 = SeparableConvBn2D(2 * c, 2 * c, act=False)
        self.SeparableConvBn2D_2 = SeparableConvBn2D(2 * c, 4 * c, stride=2)
        self.SeparableConvBn2D_3 = SeparableConvBn2D(4 * c, 4 * c)
        self.DeconvBn_0 = DeconvBn(4 * c, 2 * c, rank=2)
        self.DeconvBn_1 = DeconvBn(2 * c, c, rank=2)

    def forward(self, x):
        c2 = self.SeparableConvBn2D_1(self.SeparableConvBn2D_0(x))
        c4 = self.SeparableConvBn2D_3(self.SeparableConvBn2D_2(F.relu(c2)))
        up1 = F.relu(self.DeconvBn_0(c4) + c2)
        return F.relu(self.DeconvBn_1(up1) + x)


class Hourglass3DSeparable(nn.Module):
    """3-D hourglass of inverted-residual separable 3-D convolutions."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.MobileV2Block3D_0 = MobileV2Block3D(c, 2 * c, stride=2)
        self.MobileV2Block3D_1 = MobileV2Block3D(2 * c, 2 * c)
        self.MobileV2Block3D_2 = MobileV2Block3D(2 * c, 4 * c, stride=2)
        self.MobileV2Block3D_3 = MobileV2Block3D(4 * c, 4 * c)
        self.DeconvBn_0 = DeconvBn(4 * c, 2 * c, rank=3)
        self.DeconvBn_1 = DeconvBn(2 * c, c, rank=3)

    def forward(self, x):
        c2 = self.MobileV2Block3D_1(self.MobileV2Block3D_0(x))
        c4 = self.MobileV2Block3D_3(self.MobileV2Block3D_2(c2))
        up1 = F.relu(self.DeconvBn_0(c4) + c2)
        return F.relu(self.DeconvBn_1(up1) + x)


class _MSNet(nn.Module):
    """The shared front of both networks: stacked-pair features,
    compressed."""

    def __init__(self, max_disparity: int):
        super().__init__()
        self.max_disparity = max_disparity
        self.MobileFeatureExtractor_0 = MobileFeatureExtractor()
        self.FeatureCompressor_0 = FeatureCompressor()

    def features(self, left, right):
        n = left.shape[0]
        both = self.FeatureCompressor_0(self.MobileFeatureExtractor_0(
            torch.cat([left, right], dim=0)))
        return both[:n], both[n:]


class MSNet2D(_MSNet):
    """2-D MobileStereoNet: (N, 3, H, W) normalised views -> (N, H, W)
    disparities.  Its parameters depend on ``max_disparity``."""

    def __init__(self, max_disparity: int = 192):
        super().__init__(max_disparity)
        d4 = max_disparity // 4
        self.InterlacedVolume2D_0 = InterlacedVolume2D(d4)
        self.SeparableConvBn2D_0 = SeparableConvBn2D(d4, d4)
        self.SeparableConvBn2D_1 = SeparableConvBn2D(d4, d4)
        for i in range(3):
            self.add_module(f"Hourglass2D_{i}", Hourglass2D(d4))
            self.add_module(f"head{i}", SeparableConvBn2D(d4, d4))
            self.add_module(f"classif{i}", Conv(d4, d4, (3, 3), bias=True))

    def forward(self, left, right):
        _, _, height, width = left.shape
        fl, fr = self.features(left, right)
        volume = self.InterlacedVolume2D_0(fl, fr)          # (N, D4, H4, W4)
        x = self.SeparableConvBn2D_1(self.SeparableConvBn2D_0(volume)) + volume
        for i in range(3):
            x = getattr(self, f"Hourglass2D_{i}")(x)
        logits = self.classif2(self.head2(x))
        return upsampled_soft_argmin(logits[:, None],
                                     (self.max_disparity, height, width))


class MSNet3D(_MSNet):
    """3-D MobileStereoNet: concatenation volume + separable 3-D
    aggregation."""

    def __init__(self, max_disparity: int = 192):
        super().__init__(max_disparity)
        self.ConvBnAct_0 = ConvBnAct(64, 32, (3, 3, 3))
        self.MobileV2Block3D_0 = MobileV2Block3D(32, 32)
        for i in range(3):
            self.add_module(f"Hourglass3DSeparable_{i}",
                            Hourglass3DSeparable(32))
            self.add_module(f"head{i}", MobileV2Block3D(32, 32))
            self.add_module(f"classif{i}", Conv(32, 1, (3, 3, 3), bias=True))

    def forward(self, left, right):
        _, _, height, width = left.shape
        fl, fr = self.features(left, right)
        volume = build_concat_volume(fl, fr, self.max_disparity // 4)
        x = self.MobileV2Block3D_0(self.ConvBnAct_0(volume))
        for i in range(3):
            x = getattr(self, f"Hourglass3DSeparable_{i}")(x)
        logits = self.classif2(self.head2(x))
        return upsampled_soft_argmin(logits,
                                     (self.max_disparity, height, width))
