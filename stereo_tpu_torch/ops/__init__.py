"""Stage ops for the classical engine and Deep3D's view synthesis.

Every op is plain PyTorch; the hot stages also have hand-written CUDA
kernels under ``stereo_tpu_torch.ops.cuda``.
"""

from .imageops import (grayscale_gradient, mean_pool, rescale_generated_view,
                       rgb_to_grayscale)
from .boxfilter import box_sum_1d, box_sum_2d, wrap_pad
from .cost_volume import sad_cost_volume, sad_similarity_plane, MAX_INTENSITY
from .aggregation import mbm_aggregate
from .wta import wta_disparity
from .refinement import (quadratic_function_peak, refine_from_window,
                         sampled_sad_volume, secondary_matching)
from .fills import horizontal_fill, upscale_vertical_fill
from .shift_stack import disparity_shift_stack, weighted_shift_sum

__all__ = [
    "grayscale_gradient", "mean_pool", "rescale_generated_view",
    "rgb_to_grayscale", "box_sum_1d",
    "box_sum_2d", "wrap_pad", "sad_cost_volume", "sad_similarity_plane",
    "MAX_INTENSITY", "mbm_aggregate", "wta_disparity",
    "quadratic_function_peak", "refine_from_window", "sampled_sad_volume",
    "secondary_matching", "horizontal_fill", "upscale_vertical_fill",
    "disparity_shift_stack", "weighted_shift_sum",
]
