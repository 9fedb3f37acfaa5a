"""Failure detection for serving on a mesh
(port of ``stereo_tpu/parallel/health.py``).

A cheap per-device liveness probe, and a supervised execution wrapper that
runs recovery hooks after a failure instead of wedging the serving loop.
"""

from __future__ import annotations

import concurrent.futures
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch


@dataclass
class HealthReport:
    healthy: bool
    latency_s: float
    num_devices: int
    detail: str = ""


def _probe(devices) -> list:
    """A tiny computation on every device, read back (synchronizes)."""
    outs = [(torch.ones((8, 128), device=d) * 2.0).sum() for d in devices]
    return [float(o) for o in outs]


def check_devices(timeout_s: float = 30.0,
                  devices: Optional[Sequence] = None) -> HealthReport:
    """Run a tiny computation on every device (default: the visible CUDA
    devices) with a deadline.  A hung device shows up as a timeout rather
    than an exception, so the probe runs in a worker thread with a hard
    deadline; a timeout or an exception is reported, never raised."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if not devices:
        return HealthReport(False, 0.0, 0, "no device to probe")
    start = time.perf_counter()
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        values = pool.submit(_probe, devices).result(timeout=timeout_s)
    except concurrent.futures.TimeoutError:
        return HealthReport(False, time.perf_counter() - start, len(devices),
                            "device probe timed out")
    except Exception as exc:  # noqa: BLE001 — any device error = unhealthy
        return HealthReport(False, time.perf_counter() - start, len(devices),
                            f"probe failed: {exc}")
    finally:
        # A hung probe must not hold the caller past its deadline.
        pool.shutdown(wait=False)
    ok = all(v == 8 * 128 * 2.0 for v in values)
    return HealthReport(ok, time.perf_counter() - start, len(devices),
                        "" if ok else f"bad probe values: {values}")


class SupervisedRunner:
    """Retry wrapper for a step function: on failure, run recovery hooks
    (e.g. ``torch.distributed`` teardown and ``initialize_distributed``)
    and retry."""

    def __init__(self, recover: Optional[Callable[[], None]] = None,
                 max_retries: int = 2, backoff_s: float = 1.0):
        self.recover = recover
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.failures = 0

    def run(self, step: Callable, *args, **kwargs):
        attempt = 0
        while True:
            try:
                return step(*args, **kwargs)
            except Exception:
                self.failures += 1
                attempt += 1
                if attempt > self.max_retries:
                    raise
                time.sleep(self.backoff_s * attempt)
                if self.recover is not None:
                    self.recover()
