"""Stereo-matching backends (port of ``stereo_tpu/pipeline/backends.py``).

* ``ClassicalStereoBackend``: the classical multi-block-matching engine;
* ``DnnStereoMatchingBackend``: the stereo networks GwcNet, MSNet2D and
  MSNet3D on ImageNet-normalised input;
* ``ShardedClassicalBackend``, ``ShardedDnnBackend``: the same over a
  (data, tile, disp) device mesh (``stereo_tpu_torch.parallel``).
"""

from __future__ import annotations

import copy
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


class ShardedClassicalBackend(StereoMatchingBackend):
    """The classical engine over a device mesh (``mesh``, from
    ``parallel.make_mesh``) — selected when the pipeline config carries a
    multi-device :class:`~stereo_tpu_torch.core.config.MeshConfig`."""

    def __init__(self, config: MatchingConfig, mesh_config, mesh):
        from ..parallel import ShardedClassicalEngine

        self.engine = ShardedClassicalEngine(config, mesh_config, mesh=mesh)
        self._single_ok = mesh_config.data == 1

    def process(self, left_image, right_image) -> torch.Tensor:
        if not self._single_ok:
            raise RuntimeError("single-frame process() needs data axis == 1; "
                               "use process_batch")
        return self.engine.compute_disparity_maps(
            torch.as_tensor(left_image)[None],
            torch.as_tensor(right_image)[None])[0]

    def process_batch(self, left_batch, right_batch) -> torch.Tensor:
        return self.engine.compute_disparity_maps(left_batch, right_batch)


class ShardedDnnBackend(StereoMatchingBackend):
    """A stereo network over a device mesh (``parallel.dnn``) — selected
    when the pipeline config carries a multi-device ``MeshConfig`` and a
    DNN backend name.  Batches must be divisible by the batch group.  A
    single frame is split by rows over the first group's ``tile`` devices
    when the engine splits rows (``engine.row_split``), else it runs whole
    on the mesh's first device: the JAX package broadcasts it over the
    batch group and keeps frame 0, whose rows it splits the same way."""

    def __init__(self, model_name: str, image_shape, mesh_config, mesh,
                 max_disparity: int = 192, compute_dtype: str = "float32"):
        from ..parallel import ShardedDnnEngine

        self.engine = ShardedDnnEngine(model_name, image_shape, mesh_config,
                                       mesh=mesh, max_disparity=max_disparity,
                                       compute_dtype=compute_dtype)
        self.weights = self.engine.weights

    def process(self, left_image, right_image) -> torch.Tensor:
        return self.engine.process(left_image, right_image)

    def process_batch(self, left_batch, right_batch) -> torch.Tensor:
        return self.engine.process_batch(left_batch, right_batch)


def normalize_imagenet(images: torch.Tensor) -> torch.Tensor:
    """0..255 (..., 3, H, W) -> ImageNet-normalised float32.  The
    statistics are filled on the images' device, not copied from the
    host, so that a CUDA graph can capture it."""
    mean, std = (torch.stack([images.new_full((), v) for v in values])
                 [:, None, None] for values in (IMAGENET_MEAN, IMAGENET_STD))
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
            self.weights = load_or_init_params(
                model, model_name, checkpoint_dir=checkpoint_dir)
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

    def to(self, device) -> "DnnStereoMatchingBackend":
        """This backend on ``device``: its weights copied there, not
        loaded or converted again."""
        other = copy.copy(self)
        other.device = resolve_device(device)
        other.model = copy.deepcopy(self.model).to(other.device)
        return other

    def warmup(self) -> None:
        x = torch.zeros((1, 3, *self.image_shape), device=self.device)
        self.process_batch(x, x)
