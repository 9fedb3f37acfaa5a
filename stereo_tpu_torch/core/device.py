"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``.
Asking for CUDA on a machine without it is an error: the port never carries
on quietly on the CPU.  Tests and CPU users pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` (str or ``torch.device``) -> ``torch.device``; raises
    ``RuntimeError`` for a CUDA device when CUDA is unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def set_float32_precision(compute_dtype: str) -> None:
    """For ``compute_dtype="float32"`` keep float32 convolutions and matrix
    products in full float32: cuDNN would otherwise run convolutions in TF32
    (about three decimal digits)."""
    if compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
