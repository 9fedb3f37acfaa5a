"""What every kernel wrapper shares: the launch counts, the CPU/CUDA
dispatch rule and the argument checks before a launch."""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional, Tuple

import torch

# Kernel launches by kernel name; a wrapper adds one where it launches.
# "matching_core[rows_prepadded]" and "sampled_window[rows_prepadded]"
# count the launches in the row-halo mode, which the kernel's own count
# includes.  A launch recorded into a CUDA graph is counted in the graph's
# own counts instead (``capturing_counts``), and its owner adds them here
# on every replay (``add_launches``): the counts are the device's runs.
LAUNCHES = {"matching_core": 0, "sampled_window": 0, "upsample_blend": 0,
            "gwc_volume": 0, "matching_core[rows_prepadded]": 0,
            "sampled_window[rows_prepadded]": 0}

_capture = threading.local()
# The shards of a row split (``parallel.rows``) launch from threads of
# their own: an addition to a count is read, added and written under it.
_counts_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """Add one launch of ``name``: to ``LAUNCHES``, or to the counts of
    the graph this thread is capturing."""
    counts = getattr(_capture, "counts", None)
    with _counts_lock:
        (LAUNCHES if counts is None else counts)[name] += 1


@contextlib.contextmanager
def capturing_counts(counts: Optional[Dict[str, int]] = None
                     ) -> Iterator[Dict[str, int]]:
    """Inside the block this thread's launches go to the dict it yields
    (the counts of a CUDA graph being captured), not to ``LAUNCHES``:
    ``counts``, or new counts of zero.  A row split's shard threads add
    to the counts of the graph their caller captures."""
    if counts is None:
        counts = {name: 0 for name in LAUNCHES}
    outer = getattr(_capture, "counts", None)
    _capture.counts = counts
    try:
        yield counts
    finally:
        _capture.counts = outer


def thread_counts() -> Optional[Dict[str, int]]:
    """The counts this thread's launches go to while it captures a graph
    (``capturing_counts``), else None."""
    return getattr(_capture, "counts", None)


def add_launches(counts: Dict[str, int]) -> None:
    """Add a captured graph's counts to ``LAUNCHES`` (once per replay)."""
    for name, n in counts.items():
        LAUNCHES[name] += n


def use_kernel(t: torch.Tensor, name: str) -> bool:
    """True for the kernel (a CUDA tensor), False for the plain version (a
    CPU tensor); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` when grad mode is on and an input requires a
    gradient: a kernel launched through ctypes records no ``grad_fn``, so
    its output would cut the gradient without a word.  The modules'
    training mode runs differentiable plain versions instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{name}: the CUDA kernel has no gradient, but an input requires "
            f"one; train in the module's training mode (module.train()), "
            f"which does not launch it, or run under torch.no_grad()")


def require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(message)


def check_cuda(name: str, t: torch.Tensor, device: torch.device,
               shape: Tuple[int, ...],
               dtypes: Tuple[torch.dtype, ...] = (torch.float32,)) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` on ``device``
    with a dtype in ``dtypes`` (float32 unless the kernel says otherwise):
    the only layout the kernels take."""
    require(t.device == device, f"{name} is on {t.device}, expected {device}")
    require(t.dtype in dtypes, f"{name} must be one of {dtypes}, got {t.dtype}")
    require(tuple(t.shape) == tuple(shape),
            f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    require(t.is_contiguous(), f"{name} must be contiguous")
