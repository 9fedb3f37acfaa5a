"""Per-stage timing (port of ``stereo_tpu/utils/profiling.py``).

On a CUDA device the clocks are CUDA events recorded on the current stream,
so they measure device time without a synchronisation inside the timed
code.  Each new stage folds the stages whose events have completed into
the totals, so the pending events stay few however long the timer runs;
the rest are read (one synchronisation) when a summary is asked for.  On
the CPU they are host clocks.  ``device_trace`` records a ``torch.profiler``
trace of a block as a Chrome trace file.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def perf_clock(name: str, log: bool = True,
               device: Optional[torch.device] = None) -> Iterator[None]:
    """Time a block and print it; on a CUDA ``device`` the block's device
    work is waited for before the clock stops."""
    start = time.perf_counter()
    try:
        yield
    finally:
        if log:
            if device is not None and device.type == "cuda":
                torch.cuda.synchronize(device)
            print(f"[{name}]: {time.perf_counter() - start:.4f} seconds")


class StageTimer:
    """Accumulating per-stage timer: mean seconds per stage across frames.

    ``device``: a CUDA device times with CUDA events, anything else with
    host clocks.
    """

    def __init__(self, device: Optional[torch.device] = None):
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.device = device
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._pending: list = []

    @property
    def pending(self) -> int:
        """Stages recorded on the device and not yet folded into the
        totals."""
        return len(self._pending)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        if self.cuda:
            self._fold_completed()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._pending.append((name, start, end))
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._add(name, time.perf_counter() - t0)

    def _add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def _fold_completed(self) -> None:
        """Fold every pending stage whose end event has completed."""
        waiting = []
        for name, start, end in self._pending:
            if end.query():
                self._add(name, start.elapsed_time(end) / 1000.0)
            else:
                waiting.append((name, start, end))
        self._pending = waiting

    def summary(self) -> dict[str, float]:
        if self._pending:
            torch.cuda.synchronize(self.device)
            for name, start, end in self._pending:
                self._add(name, start.elapsed_time(end) / 1000.0)
            self._pending.clear()
        return {name: self.totals[name] / self.counts[name]
                for name in self.totals}

    def reset(self) -> None:
        self.summary()
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[str]:
    """Trace the block with ``torch.profiler`` (host activity, and the
    card's kernels when CUDA is available) and write it as a Chrome trace
    (``chrome://tracing``, Perfetto) into ``log_dir``; yields the file's
    path."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
