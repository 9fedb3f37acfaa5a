from ..core.config import PipelineConfig
from .backends import ClassicalStereoBackend, StereoMatchingBackend
from .depth_pipeline import DepthEstimationPipeline, DepthEstimationResult
from .single_view import SingleViewEngine

__all__ = ["ClassicalStereoBackend", "StereoMatchingBackend",
           "DepthEstimationPipeline", "DepthEstimationResult",
           "PipelineConfig", "SingleViewEngine"]
