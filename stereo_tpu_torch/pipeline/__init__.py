from ..core.config import PipelineConfig as DepthEstimationPipelineConfig
from ..core.config import PipelineConfig
from .backends import (AVAILABLE_DNN_BACKENDS, ClassicalStereoBackend,
                       DnnStereoMatchingBackend, StereoMatchingBackend)
from .depth_pipeline import (DepthEstimationPipeline,
                             DepthEstimationPipelineContext,
                             DepthEstimationResult)
from .runner import (extract_config_from_camera, reduce_metrics,
                     run_depth_estimation_pipeline,
                     run_depth_estimation_pipeline_batched,
                     run_depth_estimation_pipeline_evaluation,
                     validate_pipeline_config_wrt_camera)
from .single_view import SingleViewEngine

__all__ = [
    "AVAILABLE_DNN_BACKENDS", "ClassicalStereoBackend",
    "DnnStereoMatchingBackend", "StereoMatchingBackend",
    "DepthEstimationPipeline", "DepthEstimationPipelineConfig",
    "PipelineConfig", "DepthEstimationPipelineContext",
    "DepthEstimationResult", "SingleViewEngine",
    "extract_config_from_camera", "reduce_metrics",
    "run_depth_estimation_pipeline", "run_depth_estimation_pipeline_batched",
    "run_depth_estimation_pipeline_evaluation",
    "validate_pipeline_config_wrt_camera",
]
