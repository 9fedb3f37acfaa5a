"""Configuration dataclasses for the PyTorch/CUDA stereo depth port.

A copy of ``stereo_tpu/core/config.py`` with one change: the classical
engine's implementation selector names this package's paths
(``MatchingConfig.impl``).

Design notes
------------
All configs are frozen (hashable) dataclasses.  This replaces the
reference's mutable config objects (the POD struct in
``csrc/depth/stereo_matching_configuration.hh:5-17`` and the dataclass in
``src/python/pipeline/depth_estimation_pipeline.py:14-28``) with a single
validated config tree.

The reference has a ``width=1980`` typo in its pybind defaults
(``csrc/depth/torch_extension_module.cc:10``); we normalize to 1920 which is
what the C++ struct default and the shipped Middlebury calib use.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _replace(cfg, **kwargs):
    return dataclasses.replace(cfg, **kwargs)


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    """Classical multi-block-matching engine configuration.

    Mirrors the parameter surface of the reference's native config
    (``csrc/depth/stereo_matching_configuration.hh:5-17``):
    image size, downscale factor ``k``, disparity range (full-resolution
    units), SAD patch radii for cost-volume construction and subpixel
    refinement, the linear-interpolation threshold used by the disparity
    fills, and the three multi-block aggregation radii.
    """

    height: int = 1080
    width: int = 1920
    downscale_factor: int = 2
    min_disparity: int = 75
    max_disparity: int = 262
    cost_patch_radius: int = 1    # "ncc_patch_radius" in the reference
    sad_patch_radius: int = 5
    threshold: int = 5
    small_mbm_radius: int = 1
    mid_mbm_radius: int = 4
    large_mbm_radius: int = 10
    # Implementation selector: "auto" runs the hand-written CUDA kernels on
    # CUDA tensors and their plain PyTorch versions on CPU tensors;
    # "torch" forces the plain composition (materialized cost volume) on
    # any device; "cuda" requires CUDA tensors and the kernels.
    impl: str = "auto"

    def __post_init__(self):
        if self.height <= 0 or self.width <= 0:
            raise ValueError("image dimensions must be positive")
        if self.downscale_factor < 1:
            raise ValueError("downscale_factor must be >= 1")
        if not (0 <= self.min_disparity <= self.max_disparity):
            raise ValueError("require 0 <= min_disparity <= max_disparity")
        if self.impl not in ("auto", "torch", "cuda"):
            raise ValueError(f"unknown impl: {self.impl!r}")

    # Derived static shapes -------------------------------------------------
    @property
    def k(self) -> int:
        return self.downscale_factor

    @property
    def down_height(self) -> int:
        return -(-self.height // self.k)

    @property
    def down_width(self) -> int:
        return -(-self.width // self.k)

    @property
    def min_disparity_down(self) -> int:
        return self.min_disparity // self.k

    @property
    def max_disparity_down(self) -> int:
        return self.max_disparity // self.k

    @property
    def num_disparities_down(self) -> int:
        """Depth of the downscaled cost volume
        (``csrc/depth/buffer/device_buffer.cc:9``)."""
        return self.max_disparity_down - self.min_disparity_down + 1

    replace = _replace


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level depth-estimation pipeline configuration.

    Parity with ``DepthEstimationPipelineConfig``
    (``src/python/pipeline/depth_estimation_pipeline.py:14-21``); adds the
    mesh/sharding section used by the distributed engine.
    """

    image_shape: Tuple[int, int] = (384, 1280)
    min_disparity: int = 1
    max_disparity: int = 64
    invalid_disparity: float = -1.0
    stereo_matching_backend: str = "classical"  # "classical"|"gwcnet"|"msnet2d"|"msnet3d"
    log_perf_time: bool = False
    matching: Optional[MatchingConfig] = None   # derived if None
    mesh: Optional["MeshConfig"] = None
    # DNN compute precision for the neural paths (the DNN matching backends
    # and Deep3D right-view synthesis): "bfloat16" runs their forwards in
    # bf16 (≈1 gray level on the synthesized view); "float32" runs them in
    # full float32 with TF32 switched off.  The classical engine is
    # unaffected (exactness is its contract).
    compute_dtype: str = "float32"
    # Deep3D checkpoint for right-view synthesis (None = the default
    # committed weights); its npz meta selects resolution and model variant.
    rvs_checkpoint: Optional[str] = None

    _BACKENDS = ("classical", "cuda", "gwcnet", "msnet2d", "msnet3d")

    def __post_init__(self):
        if self.stereo_matching_backend not in self._BACKENDS:
            raise ValueError(
                f"Unsupported stereo matching backend: {self.stereo_matching_backend!r}; "
                f"expected one of {self._BACKENDS}"
            )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"Unsupported compute_dtype: {self.compute_dtype!r}; "
                "expected 'float32' or 'bfloat16'")

    def update(self, **kwargs) -> "PipelineConfig":
        """Validated functional update (reference semantics of
        ``DepthEstimationPipelineConfig.update``,
        ``depth_estimation_pipeline.py:23-28``, but immutable)."""
        for key in kwargs:
            if not hasattr(self, key):
                raise RuntimeError(f"Unexpected keyword argument: '{key}'.")
        return dataclasses.replace(self, **kwargs)

    def matching_config(self) -> MatchingConfig:
        """The classical engine config implied by this pipeline config
        (parity with ``depth_estimation_pipeline.py:80-86``)."""
        if self.matching is not None:
            return self.matching
        return MatchingConfig(
            height=self.image_shape[0],
            width=self.image_shape[1],
            min_disparity=self.min_disparity,
            max_disparity=self.max_disparity,
        )

    replace = _replace


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the distributed engine.

    Axes:
      * ``data``  — batch/video frames (DCN-friendly, across hosts)
      * ``tile``  — image scanline tiles (ICI halo exchange for aggregation)
      * ``disp``  — disparity-axis shards (ICI argmax reduction for WTA)
    """

    data: int = 1
    tile: int = 1
    disp: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.tile * self.disp

    replace = _replace


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Right-view-synthesis training hyperparameters
    (parity: ``src/python/pipeline/synthesis/trainer.py:13-23``)."""

    n_epochs: int = 100
    batch_size: int = 2
    learning_rate: float = 2.0e-4
    momentum: float = 0.9           # Adam beta1, as in the reference
    weight_decay: float = 1.0e-4
    step_size: int = 30
    gamma: float = 0.1
    save_path: Optional[str] = None
    log_every: int = 10

    replace = _replace
