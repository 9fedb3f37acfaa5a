"""Single-view engine: the headline scenario, one left view in, disparity
out (port of ``stereo_tpu/pipeline/single_view.py``).

Deep3D synthesizes the right view, then the stereo-matching backend runs
on the ORIGINAL left view and the synthesized right view (not on the
resized or normalised left view), as in the reference's
``depth_estimation_pipeline.py:55-66`` composition.  On a CUDA device the
path runs hand-written kernels in every frame: ``upsample_blend``, then
``matching_core`` and ``sampled_window`` (classical backend) or
``gwc_volume`` (GwcNet).

``FusedSingleViewEngine`` runs the classical single view as the JAX
package's two executables: the Deep3D network, then the blend tail merged
with the matcher.  On CUDA each half is a captured CUDA graph per batch
size, so one host call replays every launch of a half; on the CPU the same
two halves run eagerly.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import torch

from ..core.config import MatchingConfig
from ..matching.classical import compute_disparity_map
from ..ops.cuda import CapturedGraph, GraphPool
from ..synthesis.right_view_synthesis import (fused_blend_tail,
                                              synthesize_net_batch)
from ..utils.profiling import StageTimer


class SingleViewEngine:
    """``backend``: a stereo-matching backend with ``process_batch(left,
    right)`` on the synthesis's device; ``synthesis``: a constructed
    ``RightViewSynthesis`` whose output shape is the backend's image
    shape.  ``timer`` (optional) records the two stages."""

    def __init__(self, backend, synthesis,
                 timer: Optional[StageTimer] = None):
        self.backend = backend
        self.synthesis = synthesis
        self.timer = timer

    def _stage(self, name: str):
        return self.timer.stage(name) if self.timer else contextlib.nullcontext()

    def process(self, left_image) -> Tuple[torch.Tensor, torch.Tensor]:
        """(3, H, W) 0..255 -> ``(disparity (H, W), right (3, H, W))``."""
        disparity, right = self.process_batch(torch.as_tensor(left_image)[None])
        return disparity[0], right[0]

    def process_batch(self, left_batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, 3, H, W) -> ``(disparity (N, H, W), right (N, 3, H, W))``."""
        left = torch.as_tensor(left_batch).to(self.synthesis.device,
                                              torch.float32)
        with self._stage("right_view_generation"):
            right = self.synthesis.process_batch(left)
        with self._stage("stereo_matching"):
            disparity = self.backend.process_batch(left, right)
        return disparity, right


class FusedSingleViewEngine:
    """The classical single view in two halves (the JAX package's two
    executables): (a) the network, resize, ``/255`` and
    ``prob_volume_low``; (b) ``fused_blend_tail`` and the matcher on the
    ORIGINAL left view, frame by frame.

    ``config``: the matcher's ``MatchingConfig`` at the pipeline's image
    shape; ``synthesis``: a ``RightViewSynthesis`` whose output shape is
    that shape; ``timer`` (optional) records (a) as
    ``right_view_generation`` and (b) as ``stereo_matching``.

    On CUDA each batch size N gets a static input and the two halves
    captured as CUDA graphs in one memory pool shared by all of the
    engine's graphs; ``warmup()`` captures N = 1 and any other N is
    captured at its first use.  A capture or a replay that fails raises:
    nothing runs eagerly on the card.  Captures and replays hold a lock,
    so threads may share an engine.  The kernels' launches captured into a
    graph are added to ``ops.cuda.LAUNCHES`` on each replay.
    """

    def __init__(self, config: MatchingConfig, synthesis,
                 timer: Optional[StageTimer] = None):
        self.config = config
        self.synthesis = synthesis
        self.device = synthesis.device
        self.timer = timer
        # Per batch size, the network half's graph (static input: the
        # left batch) and the tail's, on the network's static outputs.
        self._graphs: Dict[int, Tuple[CapturedGraph, CapturedGraph]] = {}
        self._pool = GraphPool()
        self._lock = threading.Lock()

    @property
    def graphs_captured(self) -> int:
        """CUDA graphs captured so far (two per batch size)."""
        return 2 * len(self._graphs)

    def _stage(self, name: str):
        return self.timer.stage(name) if self.timer else contextlib.nullcontext()

    def _net(self, left: torch.Tensor):
        s = self.synthesis
        return synthesize_net_batch(s.model, left, s.model_full_shape,
                                    s.model_down_shape, s.compute_dtype)

    def _tail_and_match(self, prob_low, full01, left):
        s, cfg = self.synthesis, self.config
        right = fused_blend_tail(prob_low, full01, s.model.prob_volume_scale,
                                 (cfg.height, cfg.width), s.model_full_shape)
        with torch.no_grad():
            disparity = torch.stack([compute_disparity_map(l, r, cfg)
                                     for l, r in zip(left, right)])
        return disparity, right

    def process(self, left_image) -> Tuple[torch.Tensor, torch.Tensor]:
        """(3, H, W) 0..255 -> ``(disparity (H, W), right (3, H, W))``."""
        disparity, right = self.process_batch(torch.as_tensor(left_image)[None])
        return disparity[0], right[0]

    def process_batch(self, left_batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, 3, H, W) -> ``(disparity (N, H, W), right (N, 3, H, W))``.
        A batch of another frame shape raises ``ValueError`` (the copy into
        a graph's static input would broadcast it)."""
        left = torch.as_tensor(left_batch).to(self.device, torch.float32)
        cfg = self.config
        if left.dim() != 4 or left.shape[1:] != (3, cfg.height, cfg.width):
            raise ValueError(
                f"engine built for (N, 3, {cfg.height}, {cfg.width}) "
                f"batches, got a batch of shape {tuple(left.shape)}")
        if self.device.type != "cuda":
            with self._stage("right_view_generation"):
                prob_low, full01 = self._net(left)
            with self._stage("stereo_matching"):
                return self._tail_and_match(prob_low, full01, left)
        with self._lock:
            graphs = self._graphs.get(left.shape[0])
            if graphs is None:
                graphs = self._capture(left.shape[0])
            net, tail = graphs
            with self._stage("right_view_generation"):
                net.replay(left)
            with self._stage("stereo_matching"):
                # Clones, so that the next replay does not overwrite what
                # this call returns.
                disparity, right = (t.clone() for t in tail.replay())
        return disparity, right

    def _capture(self, n: int) -> Tuple[CapturedGraph, CapturedGraph]:
        """Capture the two halves at batch size ``n`` (under the lock)."""
        cfg, dev = self.config, self.device
        left = torch.zeros((n, 3, cfg.height, cfg.width), device=dev)
        # One eager run on a side stream first, as CUDA graph capture
        # requires: it builds the kernels, creates the libraries' handles
        # and allocates their workspaces.
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._tail_and_match(*self._net(left), left)
        torch.cuda.current_stream(dev).wait_stream(side)
        net = self._pool.capture(dev, self._net, left)
        tail = self._pool.capture(dev, self._tail_and_match, *net.outputs,
                                  left)
        self._graphs[n] = net, tail
        return net, tail

    def warmup(self) -> None:
        """One batch of zeros at N = 1: on CUDA this captures its graphs."""
        x = torch.zeros((1, 3, self.config.height, self.config.width),
                        device=self.device)
        self.process_batch(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
