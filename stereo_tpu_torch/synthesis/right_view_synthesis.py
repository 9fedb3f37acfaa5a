"""Right-view synthesis: the Deep3D inference wrapper
(port of ``stereo_tpu/synthesis/right_view_synthesis.py``).

Resizes the left view to the model's native 384x1280 full / 96x320
downscaled resolution (skipped when it is already there), scales to 0..1,
runs Deep3D (its tail is the ``upsample_blend`` kernel on CUDA), rescales to
0..255 (``ops.rescale_generated_view``) and resizes back to the output
shape.  Bilinear resizes antialias when they downscale, as
``jax.image.resize`` does.

Inference is split as in the JAX package: ``synthesize_net_batch`` (the
resizes and the network up to its softmax volume) and ``fused_blend_tail``
(the blend kernel, the rescale and the output resize).  The fused
single-view engine (``pipeline/single_view.py``) captures the two halves
as two CUDA graphs; ``RightViewSynthesis.split_inference`` says whether it
may.  ``synthesize_rows`` is their counterpart for a shard of a row split
(``parallel.synthesis``): the network and the blend on the shard's rows of
the resized views.
``python -m stereo_tpu_torch.synthesis.right_view_synthesis IMAGE``
synthesizes one right view and writes both views as PNGs.
"""

from __future__ import annotations

import copy
import os
import warnings
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.device import resolve_device, set_float32_precision
from ..models import Deep3D, init_deep3d_params, load_deep3d_checkpoint
from ..models.deep3d import _fused_blend_eligible
from ..ops import rows
from ..ops.cuda import upsample_blend
from ..ops.imageops import rescale_generated_view
from ..utils.orbax import is_orbax_dir
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


def synthesize_net_batch(model: Deep3D, left_nchw: torch.Tensor,
                         full_shape: Tuple[int, int] = RVS_FULL_SHAPE,
                         down_shape: Tuple[int, int] = RVS_DOWNSCALED_SHAPE,
                         compute_dtype: torch.dtype = torch.float32):
    """The network half of split inference: (N, 3, H, W) 0..255 left views
    -> ``(prob_low, full01)``, the softmax volume at its computed
    resolution (N, 65, fh/s, fw/s) and the normalised full-size view
    (N, 3, fh, fw), both in ``compute_dtype``."""
    with torch.no_grad():
        full = resize_nchw(left_nchw, full_shape) / 255.0
        down = resize_nchw(left_nchw, down_shape) / 255.0
        prob_low = model.prob_volume_low(down.to(compute_dtype))
        return prob_low, full.to(compute_dtype)


def fused_blend_tail(prob_low: torch.Tensor, full01: torch.Tensor, scale: int,
                     output_shape: Tuple[int, int],
                     full_shape: Tuple[int, int]) -> torch.Tensor:
    """The tail half: the ``upsample_blend`` kernel (its plain version on
    the CPU), the 0..255 rescale and the resize to ``output_shape``.
    ``fused_blend_tail(*synthesize_net_batch(...))`` is Deep3D's eval
    forward with the rescale and resize of ``process_batch``."""
    with torch.no_grad():
        right = upsample_blend(prob_low.float().contiguous(),
                               full01.float().contiguous(), scale)
        right = rescale_generated_view(right)
        if tuple(output_shape) != tuple(full_shape):
            right = resize_nchw(right, output_shape)
        return right


def synthesize_rows(model: Deep3D, full01: torch.Tensor, down01: torch.Tensor,
                    compute_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """A shard's part of ``fused_blend_tail(*synthesize_net_batch(...))``
    before the output resize, inside a row split: the shard's rows of the
    normalised full and down views (float32, 0..1; the views resized on
    the whole frame) -> its rows of the right views at the full shape,
    0..255.  The network exchanges its halo rows with the neighbouring
    shards (``models/deep3d.py``); so does the blend (:func:`split_blend`).
    Outside a split it is the whole frame's synthesis."""
    with torch.no_grad():
        prob_low = model.prob_volume_low(down01.to(compute_dtype))
        right = split_blend(prob_low, full01.to(compute_dtype),
                            model.prob_volume_scale)
        return rescale_generated_view(right)


def split_blend(prob_low: torch.Tensor, view: torch.Tensor,
                scale: int) -> torch.Tensor:
    """``upsample_blend`` of a shard's rows, one launch for its batch: the
    x ``scale`` upsample of the volume needs one volume row beyond each of
    the shard's edges, so the kernel runs on the rows extended by one row
    of each neighbouring shard (none beyond the frame's top and bottom,
    where the upsample clamps, as in the whole frame) and the view by
    ``scale`` zero rows for each (the blend reads only the output's own
    view row), and the output is cropped to the shard's rows.  Each output
    row then reads the volume rows, at the same weights, that it reads in
    the whole frame.  Outside a split, the blend of the whole frames."""
    prob, above = rows.neighbour_rows(prob_low.float())
    below = prob.shape[-2] - prob_low.shape[-2] - above
    view = F.pad(view.float(), (0, 0, scale * above, scale * below))
    out = upsample_blend(prob.contiguous(), view.contiguous(), scale)
    return out.narrow(-2, scale * above, out.shape[-2]
                      - scale * (above + below))


class RightViewSynthesis:
    """Owns a Deep3D model on one device.

    ``state_dict``: Deep3D weights (from ``models.load_deep3d_npz``); when
    None the checkpoint is loaded: ``checkpoint_dir`` (an npz file, with or
    without its ``.npz``, or an Orbax directory), which raises
    ``FileNotFoundError`` when it is missing, else the committed default.
    Without either, fresh weights are drawn (``init_deep3d_params``, seed
    0) with a warning, as the JAX package initialises its model.  ``seed``:
    build seeded random weights instead of loading any.
    ``ff_weights_dtype="bfloat16"`` (the default, as in the JAX package)
    keeps the global branch's two Dense weights in bf16 and runs those
    products in bf16.  ``warmup=True`` runs one frame at construction.
    """

    def __init__(self, output_shape: Tuple[int, int] = RVS_FULL_SHAPE,
                 state_dict=None, checkpoint_dir: Optional[str] = None,
                 warmup: bool = False,
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
        fresh = False
        if state_dict is None and seed is None:
            path = _checkpoint_path(checkpoint_dir)
            if path is None:
                fresh = True
                warnings.warn(
                    f"no Deep3D checkpoint at {DEEP3D_CHECKPOINT_DIR}.npz: "
                    f"using fresh (untrained) weights", RuntimeWarning,
                    stacklevel=2)
            else:
                state_dict, meta = load_deep3d_checkpoint(path)
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
        elif fresh:
            init_deep3d_params(model, seed=0)
        model = model.to(self.device, self.compute_dtype).eval()
        ff = model.DisparityEstimationNetwork_0.FeedForwardBranch_0
        ff.Dense_0.to(ff_dtype)
        ff.Dense_1.to(ff_dtype)
        self.model = model
        # Whether the fused single-view engine may capture the two halves
        # of inference as CUDA graphs (the JAX package splits them into
        # two executables on the TPU).
        self.split_inference = _fused_blend_eligible(
            (1, 3, *self.model_full_shape), model.prob_volume_scale,
            self.device)
        if warmup:
            self.warmup()

    def to(self, device) -> "RightViewSynthesis":
        """This synthesis on ``device``: its weights copied there, not
        loaded or converted again."""
        other = copy.copy(self)
        other.device = resolve_device(device)
        other.model = copy.deepcopy(self.model).to(other.device)
        other.split_inference = _fused_blend_eligible(
            (1, 3, *self.model_full_shape), self.model.prob_volume_scale,
            other.device)
        return other

    def process(self, left_image) -> torch.Tensor:
        """(3, H, W) 0..255 -> (3, *output_shape) 0..255."""
        return self.process_batch(torch.as_tensor(left_image)[None])[0]

    def process_batch(self, left_batch) -> torch.Tensor:
        """(N, 3, H, W) 0..255 -> (N, 3, *output_shape) 0..255."""
        left = torch.as_tensor(left_batch).to(self.device, torch.float32)
        prob_low, full01 = synthesize_net_batch(
            self.model, left, self.model_full_shape, self.model_down_shape,
            self.compute_dtype)
        return fused_blend_tail(prob_low, full01,
                                self.model.prob_volume_scale,
                                self.output_shape, self.model_full_shape)

    def warmup(self) -> None:
        """One frame through the model, so that the kernels are built and
        the libraries' handles made before the first real frame."""
        self.process_batch(torch.zeros((1, 3, 64, 64), device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _checkpoint_path(checkpoint_dir: Optional[str]) -> Optional[str]:
    """The checkpoint for ``checkpoint_dir``, else for the committed
    default, else None, in the JAX package's order: an npz file (the path
    itself, or with ``.npz`` appended), then a non-empty Orbax directory.
    A missing explicit path raises instead of falling back to the default
    weights."""
    for cand in (checkpoint_dir, DEEP3D_CHECKPOINT_DIR):
        if not cand:
            continue
        npz = cand if (os.path.isfile(cand) and cand.endswith(".npz")) \
            else cand + ".npz"
        if os.path.isfile(npz):
            return npz
        if is_orbax_dir(cand):
            return cand
        if cand is checkpoint_dir:
            raise FileNotFoundError(
                f"Deep3D checkpoint not found: {checkpoint_dir!r} (no {npz} "
                f"and no non-empty Orbax directory)")
    return None


def _main(argv=None) -> None:
    """Synthesize the right view of one image and write both views
    (``{out_prefix}_left.png`` and ``{out_prefix}_right.png``)."""
    import argparse

    from ..utils.image_io import read_image_chw, write_image_chw

    parser = argparse.ArgumentParser(
        description="Synthesize the right view of one left image.")
    parser.add_argument("image", help="left view image path (PNG)")
    parser.add_argument("--out-prefix", default="rvs_smoke")
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    left = read_image_chw(args.image)
    rvs = RightViewSynthesis(checkpoint_dir=args.checkpoint_dir,
                             device=args.device)
    right = rvs.process(torch.from_numpy(left)).cpu().numpy()
    write_image_chw(f"{args.out_prefix}_left.png", left)
    write_image_chw(f"{args.out_prefix}_right.png", right)
    print(f"Wrote {args.out_prefix}_left.png / {args.out_prefix}_right.png "
          f"({right.shape[2]}x{right.shape[1]})")


if __name__ == "__main__":
    _main()
