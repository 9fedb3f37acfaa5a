"""Depth-estimation pipeline (port of ``stereo_tpu/pipeline/depth_pipeline.py``).

``DepthEstimationPipeline.process(left, right=None)`` synthesizes the right
view with Deep3D when it is not given, then runs the stereo-matching
backend: the classical matcher or a DNN (GwcNet, MSNet2D, MSNet3D).  A
config with a multi-device ``MeshConfig`` runs the sharded engines of
``stereo_tpu_torch.parallel`` and dispatches as the JAX package does: the
sharded backends, and ``process_batch(left, None)`` with the classical
backend through ``ShardedSingleViewEngine``.  On one CUDA device the
classical single view runs through ``FusedSingleViewEngine`` (two captured
CUDA graphs, the JAX package's two executables), as the JAX package routes
it on the TPU.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from ..core.config import PipelineConfig
from ..core.device import resolve_device
from ..utils.profiling import StageTimer, perf_clock
from .backends import (AVAILABLE_DNN_BACKENDS, ClassicalStereoBackend,
                       DnnStereoMatchingBackend, ShardedClassicalBackend,
                       ShardedDnnBackend, StereoMatchingBackend)
from .single_view import FusedSingleViewEngine, SingleViewEngine


@dataclasses.dataclass
class DepthEstimationResult:
    """Outputs of one ``process`` call."""

    left_image: torch.Tensor
    right_image: torch.Tensor
    disparity_map: torch.Tensor


@dataclasses.dataclass
class DepthEstimationPipelineContext:
    """Per-frame context handed to hooks; the tensors lie on the
    pipeline's device."""

    disparity_map: torch.Tensor
    left_image: torch.Tensor
    right_image: torch.Tensor
    config: PipelineConfig
    frame_index: int


class DepthEstimationPipeline:
    """The pipeline on one device (default ``"cuda"``; raises when CUDA is
    unavailable unless ``device="cpu"`` is passed).  ``synthesis``: an
    already built ``RightViewSynthesis`` to use instead of loading the
    committed checkpoint on the first single-view frame.

    Under a multi-device ``config.mesh`` the mesh's devices are
    ``mesh_devices`` when given (a list may repeat a device: a virtual
    mesh), else ``["cpu"] * n`` for ``device="cpu"`` and the first n cards
    for ``device="cuda"``, which raises when there are fewer.  Results are
    delivered on the mesh's first device.
    """

    def __init__(self, config: PipelineConfig = PipelineConfig(),
                 synthesis=None, device="cuda", mesh_devices=None):
        self._config = config
        self.device = resolve_device(device)
        self.mesh = None
        if config.mesh is not None and config.mesh.num_devices > 1:
            from ..parallel import make_mesh
            if mesh_devices is None and self.device.type == "cpu":
                mesh_devices = [self.device] * config.mesh.num_devices
            self.mesh = make_mesh(config.mesh, mesh_devices)
        self._right_view_synthesis = synthesis
        self._single_view = None
        self._fused_sv_engine = None
        self._sharded_sv_engine = None
        self._timer = StageTimer(self.device)
        self._stereo_matching = self._build_backend()
        print(f"Using '{config.stereo_matching_backend}' as stereo matching "
              f"backend.")

    def get_configuration(self) -> PipelineConfig:
        return self._config

    @property
    def stereo_matching(self) -> StereoMatchingBackend:
        return self._stereo_matching

    def _as_tensor(self, images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        return images.to(self.device, torch.float32)

    def process(self, left_image, right_image=None) -> DepthEstimationResult:
        """One frame: (3, H, W) float RGB (0..255) -> disparity (H, W).
        A given right view is timed as the ``right_view_generation`` stage
        too (its upload), as in the reference."""
        log, dev = self._config.log_perf_time, self.device
        left = self._as_tensor(left_image)
        if right_image is None and self.mesh is None:
            engine = self._fused_single_view() or self._single_view_engine()
            with perf_clock("Depth estimation", log, dev):
                disparity, right = engine.process(left)
        else:
            # Under a mesh a single view is synthesized here and matched by
            # the sharded backend's single-frame process(), as in the JAX
            # package.
            with self._timer.stage("right_view_generation"):
                with perf_clock("Right view generation", log, dev):
                    right = (self._synthesis().process(left)
                             if right_image is None
                             else self._as_tensor(right_image))
            with self._timer.stage("stereo_matching"):
                with perf_clock("Stereo matching", log, dev):
                    disparity = self._stereo_matching.process(left, right)
        return DepthEstimationResult(left_image=left, right_image=right,
                                     disparity_map=disparity)

    def process_batch(self, left_batch, right_batch=None) -> DepthEstimationResult:
        """(N, 3, H, W) -> (N, H, W) disparities.

        Under a multi-device mesh with the classical backend the
        single-view path (``right_batch=None``) runs on the mesh
        (``parallel.synthesis``): Deep3D split by rows over ``tile`` when
        the engine's ``row_split`` says so, else frame-parallel, then the
        matcher per frame."""
        left = self._as_tensor(left_batch)
        if (right_batch is None and self.mesh is not None
                and self._config.stereo_matching_backend == "classical"):
            disparity, right = self._sharded_single_view().process_batch(
                left, return_right=True)
        elif right_batch is None:
            engine = self._fused_single_view() or self._single_view_engine()
            disparity, right = engine.process_batch(left)
        else:
            right = self._as_tensor(right_batch)
            with self._timer.stage("stereo_matching"):
                disparity = self._stereo_matching.process_batch(left, right)
        return DepthEstimationResult(left_image=left, right_image=right,
                                     disparity_map=disparity)

    def stage_times(self) -> dict:
        """Mean seconds per stage and frame call (device time on CUDA)."""
        return self._timer.summary()

    def reset_stage_times(self) -> None:
        self._timer.reset()

    # ------------------------------------------------------------------
    def _build_backend(self) -> StereoMatchingBackend:
        cfg = self._config
        if cfg.stereo_matching_backend in AVAILABLE_DNN_BACKENDS:
            # The 1/4-resolution volume follows the disparity range, in
            # steps of 4; the networks are fully convolutional.
            model_d = max(32, -(-int(cfg.max_disparity) // 4) * 4)
            if self.mesh is not None:
                return ShardedDnnBackend(
                    cfg.stereo_matching_backend, cfg.image_shape, cfg.mesh,
                    self.mesh, max_disparity=model_d,
                    compute_dtype=cfg.compute_dtype)
            return DnnStereoMatchingBackend(
                cfg.stereo_matching_backend, image_shape=cfg.image_shape,
                max_disparity=model_d, compute_dtype=cfg.compute_dtype,
                device=self.device)
        if self.mesh is not None:
            return ShardedClassicalBackend(cfg.matching_config(), cfg.mesh,
                                           self.mesh)
        return ClassicalStereoBackend(cfg.matching_config(),
                                      device=self.device)

    def _synthesis(self):
        if self._right_view_synthesis is None:
            from ..synthesis import RightViewSynthesis
            self._right_view_synthesis = RightViewSynthesis(
                output_shape=self._config.image_shape,
                compute_dtype=self._config.compute_dtype,
                checkpoint_dir=self._config.rvs_checkpoint,
                device=self.device)
        return self._right_view_synthesis

    def _sharded_single_view(self):
        if self._sharded_sv_engine is None:
            from ..parallel import ShardedSingleViewEngine
            cfg = self._config
            self._sharded_sv_engine = ShardedSingleViewEngine(
                cfg.matching_config(), cfg.mesh, mesh=self.mesh,
                synthesis=self._right_view_synthesis,
                checkpoint_dir=cfg.rvs_checkpoint,
                compute_dtype=cfg.compute_dtype)
            self._right_view_synthesis = self._sharded_sv_engine.synthesis
            self._check_disparity_coverage(self._right_view_synthesis)
        return self._sharded_sv_engine

    def _fused_single_view(self) -> Optional[FusedSingleViewEngine]:
        """The fused engine of the single-device classical single view, or
        None: for a DNN backend, a mesh of more than one device, or a
        synthesis without split inference (the CPU).  Its network graph is
        timed as ``right_view_generation``, the tail and matcher graph as
        ``stereo_matching``."""
        if self._fused_sv_engine is not None:
            return self._fused_sv_engine
        cfg = self._config
        if cfg.stereo_matching_backend not in ("classical", "cuda"):
            return None
        if self.mesh is not None:
            return None
        synthesis = self._synthesis()
        if not synthesis.split_inference:
            return None
        self._check_disparity_coverage(synthesis)
        self._fused_sv_engine = FusedSingleViewEngine(
            cfg.matching_config(), synthesis, timer=self._timer)
        return self._fused_sv_engine

    def _single_view_engine(self) -> SingleViewEngine:
        if self._single_view is None:
            synthesis = self._synthesis()
            self._check_disparity_coverage(synthesis)
            self._single_view = SingleViewEngine(
                self._stereo_matching, synthesis, timer=self._timer)
        return self._single_view

    def _check_disparity_coverage(self, synthesis) -> None:
        """The synthesized view is blended at the model's native width from
        65 shift channels, then resized to the pipeline shape: at output
        scale it can express at most 64 * W_out / W_model px of disparity.
        Warn when the matcher is asked for more."""
        from ..models.deep3d import NUM_DISPARITY_CHANNELS

        w_model = synthesis.model_full_shape[1]
        coverage = (NUM_DISPARITY_CHANNELS - 1) * (
            self._config.image_shape[1] / w_model)
        if self._config.max_disparity > coverage + 0.5:
            warnings.warn(
                f"single-view pipeline at {self._config.image_shape} "
                f"asks for disparities up to {self._config.max_disparity}"
                f" but the {w_model}-wide Deep3D checkpoint can "
                f"synthesize at most ~{coverage:.0f} px at this output "
                f"scale; evaluate at the model's native shape",
                stacklevel=4)
