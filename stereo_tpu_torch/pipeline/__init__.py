from ..core.config import PipelineConfig
from .backends import (AVAILABLE_DNN_BACKENDS, ClassicalStereoBackend,
                       DnnStereoMatchingBackend, StereoMatchingBackend)
from .depth_pipeline import DepthEstimationPipeline, DepthEstimationResult
from .single_view import SingleViewEngine

__all__ = ["AVAILABLE_DNN_BACKENDS", "ClassicalStereoBackend",
           "DnnStereoMatchingBackend", "StereoMatchingBackend",
           "DepthEstimationPipeline", "DepthEstimationResult",
           "PipelineConfig", "SingleViewEngine"]
