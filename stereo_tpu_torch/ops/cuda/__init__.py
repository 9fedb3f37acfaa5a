"""Hand-written CUDA kernels of the port, with their wrappers.

Each wrapper takes its kernel's plain PyTorch version for a CPU tensor and
launches the kernel for a CUDA tensor (or raises on a device, dtype, shape
or layout the kernel does not take).  ``LAUNCHES`` counts kernel launches,
one per launch and nowhere else, so a run can show that its main path went
through the kernels.  Nothing here imports or builds CUDA code at import
time: the library is built on the first launch (``build.library``).
"""

from .launch import LAUNCHES, reset_launch_counts
from .blend import upsample_blend, upsample_blend_plain
from .gwc_volume import gwc_volume, gwc_volume_plain
from .matching import (matching_core, matching_core_plain, sampled_window,
                       sampled_window_plain)

__all__ = ["LAUNCHES", "reset_launch_counts", "gwc_volume",
           "gwc_volume_plain", "matching_core",
           "matching_core_plain", "sampled_window", "sampled_window_plain",
           "upsample_blend", "upsample_blend_plain"]
