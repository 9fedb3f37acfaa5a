"""Deep3D right-view synthesis network (port of ``stereo_tpu/models/deep3d.py``).

A VGG16 encoder over the 4x-downscaled left view, per-pool-stage branches
each predicting a 65-channel disparity distribution, a fully connected
global branch, branch summation, a softmax upconvolution, and the x4
upsample + 65-way shifted-view blend.  The mode is ``module.training``:
eval mode runs the fused ``ops.cuda.upsample_blend`` kernel (which has no
gradient); training mode runs the differentiable upsample and shifted
blend and the global branch's dropout, as the JAX package does with
``train=True``.

Submodules carry the Flax module names (``VggBlock_0.Conv_1`` ...) so the
committed Flax checkpoint maps onto ``state_dict`` keys by name
(``models.deep3d_state_dict_from_flax``).  Tensors are NCHW; the global
branch flattens its input in NHWC order, as the Flax model does, because
the rows of its first Dense kernel are in (h, w, c) order.

Inside a row split (``parallel.synthesis``) every row-mixing layer goes
through the funnels of ``ops.rows``: the 3x3 convolutions and the parity
deconvolutions take their halo rows from the neighbouring shards, and the
shards' rows are gathered before the first pool that would not pool a
shard's rows whole, or before the global branch's Dense layers over the
whole pool5 grid.  The levels below the gather run on the whole frame on
every shard, and their branch outputs are narrowed back to the shard's
rows.  In training mode (``parallel.train``) the volume's upsample takes
one volume row of each neighbour (``ops.rows.upsample_bilinear``), and the
blend, which shifts along columns only, runs on the shard's own rows.
Outside a split nothing changes.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import rows
from ..ops.cuda import upsample_blend
from ..ops.shift_stack import weighted_shift_sum
from .layers import Deconv2dParity

NUM_DISPARITY_CHANNELS = 65


def _fused_blend_eligible(full_shape, scale: int, device) -> bool:
    """True when the blend tail can run as the ``upsample_blend`` kernel
    in a CUDA graph of its own: a CUDA ``device`` and a full shape whose
    height and width ``scale`` divides, so that the view is exactly
    ``scale`` times the volume (``ops/cuda/blend.py``).  False on the CPU,
    as the JAX package's counterpart is off the TPU."""
    if torch.device(device).type != "cuda":
        return False
    h, w = int(full_shape[-2]), int(full_shape[-1])
    return h % scale == 0 and w % scale == 0

# VGG16 convolutional configuration, split at MaxPool boundaries.
VGG16_BLOCKS: Tuple[Tuple[int, ...], ...] = (
    (64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
_VGG_STRIDE = 32


class Conv3x3(nn.Conv2d):
    """``nn.Conv2d(cin, cout, 3, padding=1)`` whose row pair comes from
    the neighbouring shards inside a row split (``ops.rows.conv2d``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, padding=1)

    def forward(self, x):
        return rows.conv2d(x, self.weight, self.bias)


class VggBlock(nn.Module):
    """N 3x3 conv + ReLU layers followed by a 2x2 max pool."""

    def __init__(self, in_channels: int, channels: Sequence[int]):
        super().__init__()
        self.n = len(channels)
        for i, ch in enumerate(channels):
            self.add_module(f"Conv_{i}", Conv3x3(in_channels, ch))
            in_channels = ch

    def convolve(self, x):
        """The block's convolutions, without its pool."""
        for i in range(self.n):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        return x

    def forward(self, x):
        return rows.max_pool2d(self.convolve(x))


class DeconvBranch(nn.Module):
    """conv3x3 -> relu -> conv3x3 -> relu -> transposed conv to 65 channels
    upsampling by ``scale`` (a 1x1 conv at scale 1)."""

    def __init__(self, in_channels: int, filters: int, scale: int):
        super().__init__()
        self.scale = scale
        self.Conv_0 = Conv3x3(in_channels, filters)
        self.Conv_1 = Conv3x3(filters, filters)
        if scale == 1:
            self.Conv_2 = nn.Conv2d(filters, NUM_DISPARITY_CHANNELS, 1)
        else:
            self.ConvTranspose_0 = Deconv2dParity(
                filters, NUM_DISPARITY_CHANNELS, scale)

    def forward(self, x):
        x = F.relu(self.Conv_1(F.relu(self.Conv_0(x))))
        if self.scale == 1:
            return self.Conv_2(x)
        return self.ConvTranspose_0(x)


def dropout_keep(generator: torch.Generator, shape,
                 device) -> torch.Tensor:
    """The global branch's dropout mask of ``shape`` (N, hidden): True
    where a hidden unit is kept, each with probability 1/2, drawn from
    ``generator``."""
    return torch.rand(shape, generator=generator, device=device) < 0.5


class FeedForwardBranch(nn.Module):
    """Global branch: fc (h*w*512 -> 4096) -> relu -> fc (-> h*w*65),
    reshaped NHWC to (h, w, 65) and deconvolved x16.

    ``dense_dtype=torch.bfloat16`` runs the two fc products in bf16 in
    eval mode (their weights are then stored in bf16 too); the branch
    output is cast back to the input dtype before summation.  Training
    keeps them in float32 and drops half the hidden units (scaling the
    rest by 2, Flax's ``Dropout(0.5)``), drawing the mask from the
    ``generator`` passed to ``forward`` (:func:`dropout_keep`), or taking
    the mask itself in its place (a boolean (N, hidden) tensor: a shard's
    frames of the mask drawn for the whole batch); without either, no
    dropout.
    """

    def __init__(self, grid: Tuple[int, int], in_channels: int = 512,
                 hidden_dim: int = 4096,
                 dense_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.grid = tuple(grid)
        self.dense_dtype = dense_dtype
        gh, gw = self.grid
        self.Dense_0 = nn.Linear(gh * gw * in_channels, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, gh * gw * NUM_DISPARITY_CHANNELS)
        self.ConvTranspose_0 = Deconv2dParity(NUM_DISPARITY_CHANNELS,
                                              NUM_DISPARITY_CHANNELS, 16)

    def _dense(self, layer: nn.Linear, x):
        # Product, then bias, each rounded in the working dtype.
        return F.linear(x, layer.weight.to(x.dtype)) + layer.bias.to(x.dtype)

    def forward(self, x_nchw, generator=None):
        n = x_nchw.shape[0]
        x = x_nchw.permute(0, 2, 3, 1).reshape(n, -1)
        dtype = torch.float32 if self.training else self.dense_dtype
        if dtype is not None:
            x = x.to(dtype)
        x = F.relu(self._dense(self.Dense_0, x))
        if self.training and generator is not None:
            keep = (generator.to(x.device)
                    if isinstance(generator, torch.Tensor)
                    else dropout_keep(generator, x.shape, x.device))
            x = torch.where(keep, x / 0.5, torch.zeros_like(x))
        x = self._dense(self.Dense_1, x).to(x_nchw.dtype)
        gh, gw = self.grid
        x = x.reshape(n, gh, gw, NUM_DISPARITY_CHANNELS).permute(0, 3, 1, 2)
        return self.ConvTranspose_0(x)


class DisparityUpconvSoftmax(nn.Module):
    """Final head: deconv x2 (one more stage at ``prob_volume_scale=2``) ->
    relu -> conv3x3 -> softmax over the 65 disparity channels."""

    def __init__(self, n_upconvs: int = 1):
        super().__init__()
        self.n_upconvs = n_upconvs
        for i in range(n_upconvs):
            self.add_module(f"ConvTranspose_{i}", Deconv2dParity(
                NUM_DISPARITY_CHANNELS, NUM_DISPARITY_CHANNELS, 2))
        self.Conv_0 = Conv3x3(NUM_DISPARITY_CHANNELS, NUM_DISPARITY_CHANNELS)

    def forward(self, x):
        for i in range(self.n_upconvs):
            x = F.relu(getattr(self, f"ConvTranspose_{i}")(x))
        return torch.softmax(self.Conv_0(x), dim=1)


class DisparityEstimationNetwork(nn.Module):
    """Downscaled left view (N, 3, h, w) -> (N, 65, H/s, W/s) softmax
    disparity probabilities at their computed resolution."""

    def __init__(self, down_shape: Tuple[int, int],
                 deconv_filters: Sequence[int] = (64, 128, 256, 512, 512),
                 prob_volume_scale: int = 4,
                 ff_dense_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if prob_volume_scale not in (2, 4):
            raise ValueError("prob_volume_scale must be 2 or 4")
        in_ch = 3
        scale = 1
        for idx, block in enumerate(VGG16_BLOCKS):
            scale = scale if idx == 0 else scale * 2
            self.add_module(f"VggBlock_{idx}", VggBlock(in_ch, block))
            in_ch = block[-1]
            self.add_module(f"DeconvBranch_{idx}",
                            DeconvBranch(in_ch, deconv_filters[idx], scale))
        grid = (down_shape[0] // _VGG_STRIDE, down_shape[1] // _VGG_STRIDE)
        self.FeedForwardBranch_0 = FeedForwardBranch(grid, in_ch,
                                                     dense_dtype=ff_dense_dtype)
        self.DisparityUpconvSoftmax_0 = DisparityUpconvSoftmax(
            1 + (prob_volume_scale == 2))

    def forward(self, left_down_nchw,
                generator: Optional[torch.Generator] = None):
        predictions = []
        gathered_from = None    # the first prediction of the whole frame
        features = left_down_nchw
        with contextlib.ExitStack() as whole:
            def gather(x):
                x = rows.gather(x)
                whole.enter_context(rows.unsplit())
                return x

            for idx in range(len(VGG16_BLOCKS)):
                block = getattr(self, f"VggBlock_{idx}")
                features = block.convolve(features)
                if rows.current() is not None and features.shape[-2] % 2:
                    features = gather(features)
                    gathered_from = idx
                features = rows.max_pool2d(features)
                predictions.append(
                    getattr(self, f"DeconvBranch_{idx}")(features))
            if rows.current() is not None:
                features = gather(features)
                gathered_from = len(predictions)
            predictions.append(self.FeedForwardBranch_0(features, generator))
        if gathered_from is not None:
            predictions[gathered_from:] = [
                rows.narrow(p) for p in predictions[gathered_from:]]
        summed = sum(predictions)
        return self.DisparityUpconvSoftmax_0(summed)


class Deep3D(nn.Module):
    """``(left_full, left_down)`` (NCHW, 0..1) -> synthesized right view
    (NCHW, 0..1).  ``left_down`` is 1/4 of the full resolution with dims
    divisible by 32; ``down_shape`` fixes the global branch's size."""

    def __init__(self, down_shape: Tuple[int, int] = (96, 320),
                 deconv_filters: Sequence[int] = (64, 128, 256, 512, 512),
                 prob_volume_scale: int = 4,
                 ff_dense_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.prob_volume_scale = prob_volume_scale
        self.DisparityEstimationNetwork_0 = DisparityEstimationNetwork(
            down_shape, deconv_filters, prob_volume_scale, ff_dense_dtype)

    def prob_volume_low(self, left_down_nchw,
                        generator: Optional[torch.Generator] = None):
        """Softmax volume at its computed resolution, (N, 65, H/s, W/s);
        ``generator`` drives the dropout in training mode."""
        return self.DisparityEstimationNetwork_0(left_down_nchw, generator)

    def disparity_probabilities(self, left_down_nchw,
                                generator: Optional[torch.Generator] = None):
        """The softmax volume upsampled x ``prob_volume_scale`` (bilinear,
        half-pixel centres): (N, 65, H, W) in right-frame coordinates."""
        prob = self.prob_volume_low(left_down_nchw, generator)
        # Inside a row split the shard's rows take one volume row of each
        # neighbour; the backward is deterministic on CUDA.
        return rows.upsample_bilinear(prob, self.prob_volume_scale)

    def synthesize_with_probabilities(
            self, left_full_nchw, left_down_nchw,
            generator: Optional[torch.Generator] = None):
        """One differentiable forward -> ``(right_view, prob (N, 65, H,
        W))``: the upsampled volume and the shifted-view blend written out
        (the JAX package's unfused path).  Output pixel y blends
        ``left[y + d]``, so the volume's soft-argmax is the right-frame
        disparity.  The blend shifts along columns only, so inside a row
        split each shard blends its own rows of both, as in the whole
        frame."""
        prob = self.disparity_probabilities(left_down_nchw, generator)
        return weighted_shift_sum(prob, left_full_nchw), prob

    def forward(self, left_full_nchw, left_down_nchw,
                generator: Optional[torch.Generator] = None):
        if self.training:
            return self.synthesize_with_probabilities(
                left_full_nchw, left_down_nchw, generator)[0]
        prob = self.prob_volume_low(left_down_nchw)
        return upsample_blend(prob.float().contiguous(),
                              left_full_nchw.float().contiguous(),
                              self.prob_volume_scale)
