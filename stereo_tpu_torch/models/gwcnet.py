"""GwcNet, the group-wise correlation stereo network (Guo et al., CVPR 2019)
(port of ``stereo_tpu/models/gwcnet.py``).

ResNet-like siamese features at 1/4 resolution (320 channels), a 40-group
correlation volume, pre-hourglass 3-D convolutions, three stacked 3-D
hourglasses and soft-argmin regressions.  The mode is ``module.training``.
Eval mode builds the volume with the ``gwc_volume`` kernel (on CUDA; it
has no gradient) and regresses ``classif3`` with the streaming head.
Training mode builds it with the differentiable composition the JAX model
runs at all times (``gwc_volume_plain``) and returns the four classifiers'
regressions, each a full trilinear upsample, a softmax over D and the
expectation (``gwcnet_loss`` weighs them 0.5/0.5/0.7/1.0).

Inside a row split (``parallel.dnn``) a shard of any whole number of rows
runs the network on its rows, the row-mixing layers reading their halo
rows from the neighbouring shards (``ops.rows``).  The strides (two in
the feature extractor, down to 1/4, two in each hourglass, down to 1/16)
each need an even number of rows in a shard: before a stride that would
split a row, or leave the 1/4 level fewer rows than its dilated blocks'
halo of two, the shard gathers the whole frame's rows and runs on them
(``ops.rows.Descent``).  Gathered in the feature extractor (4 does not
divide a shard's rows, or a shard holds 4), the rest of the network runs on the whole frame,
the volume included, and the disparities are narrowed to the shard's
rows.  Gathered in an hourglass, the deconvolution whose output meets a
skip of the shard's rows is narrowed before the addition, and the
hourglass ends on the shard's rows at 1/4.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import rows
from ..ops.cuda import gwc_volume_plain
from .cost_volumes import (build_gwc_volume, masked_huber_loss,
                           regress_full, upsampled_soft_argmin)
from .layers import BasicResBlock, Conv, ConvBnAct, DeconvBn

GWCNET_LOSS_WEIGHTS: Tuple[float, ...] = (0.5, 0.5, 0.7, 1.0)


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
        # The deepest halo at 1/4, from the strided block on: a block of
        # dilation d reads d rows of each neighbouring shard.
        first = [spec[2] for spec in specs].index(2)
        self.quarter_halo = max(spec[3] for spec in specs[first:])
        self.layer2_end = 3 + layer2_blocks          # blocks [3, layer2_end)

    def forward(self, x, descent: Optional[rows.Descent] = None):
        """``descent`` gathers the rows ahead of each stride inside a row
        split (None: no gather)."""
        stride = (descent.stride if descent is not None
                  else lambda x, depth=1: x)
        x = self.ConvBnAct_2(self.ConvBnAct_1(self.ConvBnAct_0(stride(x))))
        outs = []
        for i in range(self.num_blocks):
            block = getattr(self, f"BasicResBlock_{i}")
            x = block(stride(x, depth=self.quarter_halo)
                      if block.stride == 2 else x)
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
        with rows.Descent() as d:
            c2 = self.ConvBnAct_1(self.ConvBnAct_0(d.stride(x)))
            c4 = self.ConvBnAct_3(self.ConvBnAct_2(d.stride(F.relu(c2))))
            up1 = F.relu(d.join(self.DeconvBn_0(c4), c2) + c2)
            return F.relu(d.join(self.DeconvBn_1(up1), x) + x)


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
        with rows.Descent() as descent:
            return descent.rejoin(self._forward(left, right, descent))

    def _forward(self, left, right, descent):
        n = left.shape[0]
        # One application over the stacked pair (shared weights).
        both = self.GwcFeatureExtractor_0(torch.cat([left, right], dim=0),
                                          descent)
        out_dhw = (self.max_disparity, descent.height(left), left.shape[-1])
        build = gwc_volume_plain if self.training else build_gwc_volume
        volume = build(both[:n].contiguous(), both[n:].contiguous(),
                       self.max_disparity // 4, self.num_groups)
        x = self.ConvBnAct_1(self.ConvBnAct_0(volume))
        x = x + self.ConvBnAct_3(self.ConvBnAct_2(x))
        if not self.training:
            for i in range(3):
                x = getattr(self, f"Hourglass3D_{i}")(x)
            return upsampled_soft_argmin(self.classif3(x), out_dhw)
        outputs = [self.classif0(x)]
        for i in range(3):
            x = getattr(self, f"Hourglass3D_{i}")(x)
            outputs.append(getattr(self, f"classif{i + 1}")(x))
        return tuple(regress_full(o, out_dhw) for o in outputs)


def gwcnet_loss(outputs: Sequence[torch.Tensor], gt_disparity: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 multi-output loss (paper eq. 5): the masked Huber losses
    (delta 1) of the four outputs weighed 0.5/0.5/0.7/1.0."""
    return masked_huber_loss(outputs, GWCNET_LOSS_WEIGHTS, gt_disparity, mask)
