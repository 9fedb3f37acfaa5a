"""Depth-estimation pipeline (port of ``stereo_tpu/pipeline/depth_pipeline.py``).

``DepthEstimationPipeline.process(left, right=None)`` synthesizes the right
view with Deep3D when it is not given, then runs the stereo-matching
backend: the classical matcher or a DNN (GwcNet, MSNet2D, MSNet3D).  The
multi-device mesh is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..core.config import PipelineConfig
from ..core.device import resolve_device
from ..utils.profiling import StageTimer, perf_clock
from .backends import (AVAILABLE_DNN_BACKENDS, ClassicalStereoBackend,
                       DnnStereoMatchingBackend, StereoMatchingBackend)
from .single_view import SingleViewEngine


@dataclasses.dataclass
class DepthEstimationResult:
    """Outputs of one ``process`` call."""

    left_image: torch.Tensor
    right_image: torch.Tensor
    disparity_map: torch.Tensor


class DepthEstimationPipeline:
    """The pipeline on one device (default ``"cuda"``; raises when CUDA is
    unavailable unless ``device="cpu"`` is passed).  ``synthesis``: an
    already built ``RightViewSynthesis`` to use instead of loading the
    committed checkpoint on the first single-view frame."""

    def __init__(self, config: PipelineConfig = PipelineConfig(),
                 synthesis=None, device="cuda"):
        self._config = config
        self.device = resolve_device(device)
        if config.mesh is not None and config.mesh.num_devices > 1:
            raise NotImplementedError("multi-device meshes are not ported yet")
        self._right_view_synthesis = synthesis
        self._single_view = None
        self._timer = StageTimer(self.device)
        self._stereo_matching = self._build_backend()

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
        """One frame: (3, H, W) float RGB (0..255) -> disparity (H, W)."""
        left = self._as_tensor(left_image)
        with perf_clock("Depth estimation", self._config.log_perf_time,
                        self.device):
            if right_image is None:
                disparity, right = self._single_view_engine().process(left)
            else:
                right = self._as_tensor(right_image)
                with self._timer.stage("stereo_matching"):
                    disparity = self._stereo_matching.process(left, right)
        return DepthEstimationResult(left_image=left, right_image=right,
                                     disparity_map=disparity)

    def process_batch(self, left_batch, right_batch=None) -> DepthEstimationResult:
        """(N, 3, H, W) -> (N, H, W) disparities."""
        left = self._as_tensor(left_batch)
        if right_batch is None:
            disparity, right = self._single_view_engine().process_batch(left)
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
            return DnnStereoMatchingBackend(
                cfg.stereo_matching_backend, image_shape=cfg.image_shape,
                max_disparity=model_d, compute_dtype=cfg.compute_dtype,
                device=self.device)
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
