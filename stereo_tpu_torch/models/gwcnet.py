"""GwcNet, the group-wise correlation stereo network (Guo et al., CVPR 2019)
(port of ``stereo_tpu/models/gwcnet.py``, inference).

ResNet-like siamese features at 1/4 resolution (320 channels), a 40-group
correlation volume (the ``gwc_volume`` kernel on CUDA), pre-hourglass 3-D
convolutions, three stacked 3-D hourglasses and a soft-argmin regression
from the upsampled last classifier.  ``classif0..2`` are built so that the
committed checkpoint loads with ``strict=True``; inference runs only
``classif3``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .cost_volumes import build_gwc_volume, upsampled_soft_argmin
from .layers import BasicResBlock, Conv, ConvBnAct, DeconvBn


class GwcFeatureExtractor(nn.Module):
    """Shared-weight siamese feature extractor -> (N, 320, H/4, W/4)."""

    def __init__(self, base_channels: int = 32, layer2_blocks: int = 16):
        super().__init__()
        c = base_channels
        self.ConvBnAct_0 = ConvBnAct(3, c, (3, 3), 2)
        self.ConvBnAct_1 = ConvBnAct(c, c)
        self.ConvBnAct_2 = ConvBnAct(c, c)
        # (in, out, stride, dilation) of each residual block, in order:
        # layer1 at 1/2, layer2 at 1/4, layer3, dilated layer4.
        specs = ([(c, c, 1, 1)] * 3 + [(c, 2 * c, 2, 1)]
                 + [(2 * c, 2 * c, 1, 1)] * (layer2_blocks - 1)
                 + [(2 * c, 4 * c, 1, 1)] + [(4 * c, 4 * c, 1, 1)] * 2
                 + [(4 * c, 4 * c, 1, 2)] * 3)
        for i, (cin, cout, stride, dilation) in enumerate(specs):
            self.add_module(f"BasicResBlock_{i}",
                            BasicResBlock(cin, cout, stride, dilation))
        self.num_blocks = len(specs)
        self.layer2_end = 3 + layer2_blocks          # blocks [3, layer2_end)

    def forward(self, x):
        x = self.ConvBnAct_2(self.ConvBnAct_1(self.ConvBnAct_0(x)))
        outs = []
        for i in range(self.num_blocks):
            x = getattr(self, f"BasicResBlock_{i}")(x)
            if i in (self.layer2_end - 1, self.layer2_end + 2,
                     self.layer2_end + 5):
                outs.append(x)
        return torch.cat(outs, dim=1)                # 64 + 128 + 128


class Hourglass3D(nn.Module):
    """3-D encoder-decoder with skip connections (GwcNet §3.3)."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.ConvBnAct_0 = ConvBnAct(c, 2 * c, (3, 3, 3), 2)
        self.ConvBnAct_1 = ConvBnAct(2 * c, 2 * c, (3, 3, 3), act=False)
        self.ConvBnAct_2 = ConvBnAct(2 * c, 4 * c, (3, 3, 3), 2)
        self.ConvBnAct_3 = ConvBnAct(4 * c, 4 * c, (3, 3, 3))
        self.DeconvBn_0 = DeconvBn(4 * c, 2 * c, rank=3)
        self.DeconvBn_1 = DeconvBn(2 * c, c, rank=3)

    def forward(self, x):
        c2 = self.ConvBnAct_1(self.ConvBnAct_0(x))
        c4 = self.ConvBnAct_3(self.ConvBnAct_2(F.relu(c2)))
        up1 = F.relu(self.DeconvBn_0(c4) + c2)
        return F.relu(self.DeconvBn_1(up1) + x)


class Classifier3D(nn.Module):
    """Output head: conv-bn-relu, then a single-channel 3-D conv."""

    def __init__(self, channels: int = 32):
        super().__init__()
        self.ConvBnAct_0 = ConvBnAct(channels, channels, (3, 3, 3))
        self.Conv_0 = Conv(channels, 1, (3, 3, 3))

    def forward(self, x):
        return self.Conv_0(self.ConvBnAct_0(x))


class GwcNet(nn.Module):
    """``forward(left, right)``: (N, 3, H, W) ImageNet-normalised views ->
    (N, H, W) float32 disparities at full resolution."""

    def __init__(self, max_disparity: int = 192, num_groups: int = 40,
                 layer2_blocks: int = 16):
        super().__init__()
        self.max_disparity = max_disparity
        self.num_groups = num_groups
        self.GwcFeatureExtractor_0 = GwcFeatureExtractor(
            layer2_blocks=layer2_blocks)
        self.ConvBnAct_0 = ConvBnAct(num_groups, 32, (3, 3, 3))
        self.ConvBnAct_1 = ConvBnAct(32, 32, (3, 3, 3))
        self.ConvBnAct_2 = ConvBnAct(32, 32, (3, 3, 3))
        self.ConvBnAct_3 = ConvBnAct(32, 32, (3, 3, 3), act=False)
        for i in range(4):
            self.add_module(f"classif{i}", Classifier3D())
        for i in range(3):
            self.add_module(f"Hourglass3D_{i}", Hourglass3D(32))

    def forward(self, left, right):
        n, _, height, width = left.shape
        # One application over the stacked pair (shared weights).
        both = self.GwcFeatureExtractor_0(torch.cat([left, right], dim=0))
        volume = build_gwc_volume(both[:n].contiguous(),
                                  both[n:].contiguous(),
                                  self.max_disparity // 4, self.num_groups)
        x = self.ConvBnAct_1(self.ConvBnAct_0(volume))
        x = x + self.ConvBnAct_3(self.ConvBnAct_2(x))
        for i in range(3):
            x = getattr(self, f"Hourglass3D_{i}")(x)
        return upsampled_soft_argmin(self.classif3(x),
                                     (self.max_disparity, height, width))
