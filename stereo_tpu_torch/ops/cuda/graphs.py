"""CUDA graphs of the port's engines: a callable captured on static inputs
into a memory pool that all of an owner's graphs share, and replayed with
the kernel launches captured into it counted (``launch.add_launches``)."""

from __future__ import annotations

from typing import Any, Callable

import torch

from .launch import add_launches, capturing_counts


class CapturedGraph:
    """A captured callable: its static inputs, the graph, the kernel
    launches captured into it and what the callable returned (kept
    referenced, so that no later capture in the pool takes its memory)."""

    def __init__(self, inputs, graph, counts, outputs):
        self.inputs, self.graph = inputs, graph
        self.counts, self.outputs = counts, outputs

    def replay(self, *inputs: torch.Tensor) -> Any:
        """Copy ``inputs`` into the static inputs (as many as are given),
        replay the graph on the caller's stream, add its launches to
        ``LAUNCHES`` and return its static outputs: a caller that keeps
        them past the next replay clones them."""
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        self.graph.replay()
        add_launches(self.counts)
        return self.outputs


class GraphPool:
    """Captures into one memory pool, made at the first capture."""

    def __init__(self):
        self._handle = None

    def capture(self, device: torch.device, fn: Callable[..., Any],
                *inputs: torch.Tensor) -> CapturedGraph:
        """``fn(*inputs)`` captured as a CUDA graph on ``device`` (on
        ``torch.cuda.graph``'s side stream), the ``inputs`` becoming its
        static inputs.  The capture is "thread_local": only the capturing
        thread's unsafe calls are refused, so other threads (a row split's
        shards) may enqueue on the capture stream.  A capture that fails raises with the caller's
        stream put back: ``torch.cuda.graph`` leaves the thread on its
        capture stream when the capture fails to end, and the caller's
        later work would run unordered with the default stream's.  It
        also leaves the caching allocator recording into the pool (the
        graph ends that only after the capture has ended), and while the
        allocator counts a capture underway ``torch.cuda.empty_cache``
        frees no block of its default pool: ended here too.  PyTorch then
        still refuses a capture into that pool ("already recording"), so
        the next capture makes a pool of its own."""
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        caller = torch.cuda.current_stream(device)
        graph = torch.cuda.CUDAGraph()
        try:
            with capturing_counts() as counts, torch.cuda.graph(
                    graph, pool=self._handle,
                    capture_error_mode="thread_local"):
                outputs = fn(*inputs)
        except BaseException:
            _stop_recording(device, self._handle)
            self._handle = None
            raise
        finally:
            torch.cuda.set_stream(caller)
        return CapturedGraph(inputs, graph, counts, outputs)


def _stop_recording(device: torch.device, pool) -> None:
    """End the caching allocator's recording into ``pool`` that a failed
    capture on ``device`` left on; nothing where the capture ended (the
    allocator then says it records into the pool no longer) or where this
    PyTorch has no binding for it.  Any other error of the allocator's
    raises."""
    end = getattr(torch._C, "_cuda_endAllocateToPool", None)
    if end is None:
        return
    index = torch.device(device).index
    try:
        end(torch.cuda.current_device() if index is None else index, pool)
    except RuntimeError as e:
        if "not currently recording" not in str(e):
            raise
