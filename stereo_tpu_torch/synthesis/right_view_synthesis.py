"""Right-view synthesis: the Deep3D inference wrapper
(port of ``stereo_tpu/synthesis/right_view_synthesis.py``).

Resizes the left view to the model's native 384x1280 full / 96x320
downscaled resolution (skipped when it is already there), scales to 0..1,
runs Deep3D (its tail is the ``upsample_blend`` kernel on CUDA), rescales to
0..255 (``ops.rescale_generated_view``) and resizes back to the output
shape.  Bilinear resizes antialias when they downscale, as
``jax.image.resize`` does.
"""

from __future__ import annotations

import copy
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.device import resolve_device, set_float32_precision
from ..models import Deep3D, load_deep3d_npz
from ..ops.imageops import rescale_generated_view
from ..utils.paths import DEEP3D_CHECKPOINT_DIR

# Native Deep3D operating resolution.
RVS_FULL_SHAPE = (384, 1280)
RVS_DOWNSCALED_SHAPE = (96, 320)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resize_nchw(images: torch.Tensor, shape_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (N, C, H, W) to ``shape_hw``, antialiased when
    downscaling; the identity when the shape is already right."""
    if tuple(images.shape[-2:]) == tuple(shape_hw):
        return images
    return F.interpolate(images, size=tuple(shape_hw), mode="bilinear",
                         align_corners=False, antialias=True)


class RightViewSynthesis:
    """Owns a Deep3D model on one device.

    ``state_dict``: Deep3D weights (from ``models.load_deep3d_npz``); when
    None the committed checkpoint (``checkpoint_dir`` or the default) is
    loaded.  ``seed``: build seeded random weights instead of loading any.
    ``ff_weights_dtype="bfloat16"`` (the default, as in the JAX package)
    keeps the global branch's two Dense weights in bf16 and runs those
    products in bf16.
    """

    def __init__(self, output_shape: Tuple[int, int] = RVS_FULL_SHAPE,
                 state_dict=None, checkpoint_dir: Optional[str] = None,
                 model_full_shape: Tuple[int, int] = RVS_FULL_SHAPE,
                 model_down_shape: Tuple[int, int] = RVS_DOWNSCALED_SHAPE,
                 compute_dtype: str = "float32",
                 ff_weights_dtype: str = "bfloat16",
                 seed: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        self.output_shape = tuple(output_shape)
        self.compute_dtype = _DTYPES[compute_dtype]
        set_float32_precision(compute_dtype)
        self.model_full_shape = tuple(model_full_shape)
        self.model_down_shape = tuple(model_down_shape)
        meta = {}
        if state_dict is None and seed is None:
            state_dict, meta = load_deep3d_npz(
                _checkpoint_path(checkpoint_dir))
        if "full_shape" in meta:
            self.model_full_shape = tuple(int(v) for v in meta["full_shape"])
        if "down_shape" in meta:
            self.model_down_shape = tuple(int(v) for v in meta["down_shape"])
        ff_dtype = _DTYPES[ff_weights_dtype]
        with torch.random.fork_rng(devices=[]):
            if seed is not None:
                torch.manual_seed(seed)
            model = Deep3D(
                self.model_down_shape,
                prob_volume_scale=int(meta.get("prob_volume_scale", 4)),
                ff_dense_dtype=None if ff_dtype == torch.float32 else ff_dtype)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        model = model.to(self.device, self.compute_dtype).eval()
        ff = model.DisparityEstimationNetwork_0.FeedForwardBranch_0
        ff.Dense_0.to(ff_dtype)
        ff.Dense_1.to(ff_dtype)
        self.model = model

    def to(self, device) -> "RightViewSynthesis":
        """This synthesis on ``device``: its weights copied there, not
        loaded or converted again."""
        other = copy.copy(self)
        other.device = resolve_device(device)
        other.model = copy.deepcopy(self.model).to(other.device)
        return other

    def process(self, left_image) -> torch.Tensor:
        """(3, H, W) 0..255 -> (3, *output_shape) 0..255."""
        return self.process_batch(torch.as_tensor(left_image)[None])[0]

    def process_batch(self, left_batch) -> torch.Tensor:
        """(N, 3, H, W) 0..255 -> (N, 3, *output_shape) 0..255."""
        left = torch.as_tensor(left_batch).to(self.device, torch.float32)
        with torch.no_grad():
            full = resize_nchw(left, self.model_full_shape) / 255.0
            down = resize_nchw(left, self.model_down_shape) / 255.0
            right = self.model(full.to(self.compute_dtype),
                               down.to(self.compute_dtype))
            right = rescale_generated_view(right.float())
            return resize_nchw(right, self.output_shape)


def _checkpoint_path(checkpoint_dir: Optional[str]) -> str:
    """The npz file for ``checkpoint_dir`` (a path with or without
    ``.npz``), else the committed default; a missing explicit path raises
    instead of falling back to the default weights."""
    cand = checkpoint_dir or DEEP3D_CHECKPOINT_DIR
    npz = cand if cand.endswith(".npz") else cand + ".npz"
    if not os.path.isfile(npz):
        raise FileNotFoundError(f"Deep3D checkpoint not found: {npz!r}")
    return npz
