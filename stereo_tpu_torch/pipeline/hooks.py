"""Pipeline hooks: per-frame observers that save or log artifacts (port of
``stereo_tpu/pipeline/hooks.py``).

The hook base class with ``process`` / ``on_pipeline_start`` /
``on_pipeline_end``, ``LambdaHook``, the completion logger, the disparity
and context frame savers, the point-cloud saver and the video saver with
its reorder buffer.

Hooks receive the pipeline's CUDA tensors and move them to the host
themselves (``to_host``) on the runner's worker threads, so the main
thread never waits for the device per frame and the hooks' I/O overlaps
the next frames' device work.  That is safe because the pipeline runs on
the default stream and allocates fresh outputs per frame: a copy on a
worker thread is ordered after the kernels that wrote the tensor, and the
context keeps the tensor alive.  A pipeline that moves to side streams or
to CUDA graphs with reused output buffers must make the hooks wait on (or
copy) its outputs first.
"""

from __future__ import annotations

import os
import threading
from abc import ABC, abstractmethod
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from ..utils.image_io import (make_image_grid, open_video_writer,
                              prepare_image_grid, save_image_grid)
from ..utils.paths import timestamp_folder_name
from ..utils.pointcloud import save_point_cloud_from_depth
from .camera.camera import Camera
from .depth_pipeline import DepthEstimationPipelineContext


def to_host(array) -> np.ndarray:
    """A tensor (on any device) or array -> host NumPy array."""
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


class DepthEstimationPipelineHook(ABC):

    @abstractmethod
    def process(self, context: DepthEstimationPipelineContext) -> None:
        ...

    def on_pipeline_start(self) -> None:
        pass

    def on_pipeline_end(self) -> None:
        pass

    @staticmethod
    def invoke_in_context(hook: "DepthEstimationPipelineHook",
                          context: DepthEstimationPipelineContext) -> None:
        hook.process(context)


class LambdaHook(DepthEstimationPipelineHook):

    def __init__(self, func: Callable[[DepthEstimationPipelineContext], None]):
        self._func = func

    def process(self, context: DepthEstimationPipelineContext) -> None:
        self._func(context)


class DisparityMapCompletionLogger(DepthEstimationPipelineHook):

    def process(self, context: DepthEstimationPipelineContext) -> None:
        shape = tuple(context.disparity_map.shape)
        print(f"[hook] frame {context.frame_index}: disparity ready, shape={shape}")


class DisparityMapSaver(DepthEstimationPipelineHook):

    def __init__(self, save_dir: str):
        self._save_dir = os.path.join(save_dir, timestamp_folder_name())
        os.makedirs(self._save_dir, exist_ok=True)

    def process(self, context: DepthEstimationPipelineContext) -> None:
        path = os.path.join(self._save_dir,
                            f"disparity_map_{context.frame_index:06d}.png")
        save_image_grid(to_host(context.disparity_map), path)


class ContextFrameSaver(DepthEstimationPipelineHook):
    """Saves a left/right/disparity grid per frame."""

    def __init__(self, save_dir: str):
        self._save_dir = os.path.join(save_dir, timestamp_folder_name())
        os.makedirs(self._save_dir, exist_ok=True)

    def process(self, context: DepthEstimationPipelineContext) -> None:
        path = os.path.join(self._save_dir,
                            f"context_frame_{context.frame_index:06d}.png")
        save_image_grid([to_host(context.left_image),
                         to_host(context.right_image),
                         to_host(context.disparity_map)], path)


class PointCloudSaver(DepthEstimationPipelineHook):
    """Disparity -> depth (``b*f/d``) -> .ply point cloud, with a mask
    removing invalid-disparity pixels."""

    def __init__(self, focal_length: float, baseline: float, save_dir: str,
                 invalid_disparity: float):
        self._focal_length = focal_length
        self._baseline = baseline
        self._invalid_disparity = invalid_disparity
        self._save_dir = os.path.join(save_dir, timestamp_folder_name())

    def process(self, context: DepthEstimationPipelineContext) -> None:
        path = os.path.join(self._save_dir,
                            f"point_cloud_{context.frame_index:06d}.ply")
        disparity = to_host(context.disparity_map).astype(np.float64)
        with np.errstate(divide="ignore"):
            depth = (self._baseline * self._focal_length) / disparity
        valid = disparity != self._invalid_disparity
        save_point_cloud_from_depth(depth, valid, path)
        print(f"[hook] frame {context.frame_index}: point cloud -> {path}")

    @staticmethod
    def for_camera(camera: Camera, save_dir: str,
                   invalid_disparity: float) -> "PointCloudSaver":
        return PointCloudSaver(focal_length=camera.focal_length(),
                               baseline=camera.baseline(),
                               save_dir=save_dir,
                               invalid_disparity=invalid_disparity)


class ContextVideoSaver(DepthEstimationPipelineHook):
    """Streams one grid frame per processed frame into an mp4 writer
    (MPEG-4 Part 2, ``utils/image_io.py``), as the JAX package's saver
    does.  The writer is opened on the first frame and frames are written
    as they come, so host memory stays flat over the drive's length.

    Hook tasks run on a thread pool and may complete out of order, while a
    video must be written in frame order: a small reorder buffer holds
    early frames until their predecessors arrive.
    """

    def __init__(self, save_path: str, fps: int):
        self._fps = fps
        self._save_path = save_path
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._writer = None
        self._next_index = 0
        self._out_of_order: "OrderedDict[int, np.ndarray]" = OrderedDict()

    def _write(self, frame_hwc: np.ndarray) -> None:
        if self._writer is None:
            self._writer = open_video_writer(
                self._save_path, frame_hwc.shape[0], frame_hwc.shape[1],
                self._fps)
        self._writer.write(frame_hwc[:, :, ::-1])  # RGB -> BGR

    def process(self, context: DepthEstimationPipelineContext) -> None:
        grid = make_image_grid(prepare_image_grid([
            to_host(context.left_image),
            to_host(context.right_image),
            to_host(context.disparity_map)]), padding=10, pad_value=1.0)
        frame = np.clip(grid * 255.0 + 0.5, 0, 255).astype(np.uint8)
        frame = np.ascontiguousarray(frame.transpose(1, 2, 0))
        with self._lock:
            self._out_of_order[context.frame_index] = frame
            while self._next_index in self._out_of_order:
                self._write(self._out_of_order.pop(self._next_index))
                self._next_index += 1

    def on_pipeline_end(self) -> None:
        with self._lock:
            for index in sorted(self._out_of_order):
                self._write(self._out_of_order.pop(index))
            if self._writer is not None:
                self._writer.release()
                self._writer = None
