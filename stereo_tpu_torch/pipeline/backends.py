"""Stereo-matching backends (port of ``stereo_tpu/pipeline/backends.py``).

* ``ClassicalStereoBackend``: the classical multi-block-matching engine;
* ``DnnStereoMatchingBackend``: the stereo networks GwcNet, MSNet2D and
  MSNet3D on ImageNet-normalised input.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional, Tuple

import torch

from ..core.config import MatchingConfig
from ..core.device import resolve_device, set_float32_precision
from ..matching.classical import ClassicalStereoEngine

# ImageNet statistics of the DNN preprocessing.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

AVAILABLE_DNN_BACKENDS = ("gwcnet", "msnet2d", "msnet3d")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class StereoMatchingBackend(ABC):
    """(3, H, W) left/right RGB in 0..255 -> (H, W) float disparity."""

    @abstractmethod
    def process(self, left_image, right_image) -> torch.Tensor:
        ...


class ClassicalStereoBackend(StereoMatchingBackend):
    """The classical multi-block-matching engine."""

    def __init__(self, config: MatchingConfig, device="cuda"):
        self.engine = ClassicalStereoEngine(config, device=device)

    def process(self, left_image, right_image) -> torch.Tensor:
        return self.engine.compute_disparity_map(left_image, right_image)

    def process_batch(self, left_batch, right_batch) -> torch.Tensor:
        return self.engine.compute_disparity_maps(left_batch, right_batch)


def normalize_imagenet(images: torch.Tensor) -> torch.Tensor:
    """0..255 (..., 3, H, W) -> ImageNet-normalised float32."""
    mean = images.new_tensor(IMAGENET_MEAN)[:, None, None]
    std = images.new_tensor(IMAGENET_STD)[:, None, None]
    return (images / 255.0 - mean) / std


class DnnStereoMatchingBackend(StereoMatchingBackend):
    """A stereo network on one device (default ``"cuda"``).

    ``model_name`` is one of :data:`AVAILABLE_DNN_BACKENDS`.  Parameters
    come from ``state_dict`` when given, else from ``checkpoint_dir`` or
    the committed ``data/checkpoints/<model_name>.npz``, else a seeded
    init (``weights`` says which).  ``compute_dtype="bfloat16"`` runs
    parameters, BatchNorm statistics and inputs in bf16 and returns float32
    disparities; ``"float32"`` keeps TF32 off.
    """

    def __init__(self, model_name: str, image_shape: Tuple[int, int],
                 max_disparity: int = 192, state_dict=None,
                 checkpoint_dir: Optional[str] = None,
                 compute_dtype: str = "float32", device="cuda"):
        if model_name not in AVAILABLE_DNN_BACKENDS:
            raise RuntimeError(f"Unknown DNN backend: {model_name!r}; "
                               f"expected one of {AVAILABLE_DNN_BACKENDS}")
        from ..models import build_stereo_model, load_or_init_params

        self.device = resolve_device(device)
        self.model_name = model_name
        self.image_shape = tuple(image_shape)
        self.compute_dtype = _DTYPES[compute_dtype]
        set_float32_precision(compute_dtype)
        model = build_stereo_model(model_name, max_disparity=max_disparity)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
            self.weights = "given"
        else:
            self.weights = load_or_init_params(model, model_name,
                                               checkpoint_dir)
        self.model = model.to(self.device, self.compute_dtype).eval()

    def process(self, left_image, right_image) -> torch.Tensor:
        return self.process_batch(torch.as_tensor(left_image)[None],
                                  torch.as_tensor(right_image)[None])[0]

    def process_batch(self, left_batch, right_batch) -> torch.Tensor:
        """(N, 3, H, W) 0..255 pairs -> (N, H, W) float32 disparities."""
        left, right = (normalize_imagenet(
            torch.as_tensor(x).to(self.device, torch.float32)
        ).to(self.compute_dtype) for x in (left_batch, right_batch))
        with torch.no_grad():
            return self.model(left, right).float()

    def warmup(self) -> None:
        x = torch.zeros((1, 3, *self.image_shape), device=self.device)
        self.process_batch(x, x)
