"""Pipeline runners: stream camera frames through the pipeline, dispatch
hooks, and run metric evaluations (port of ``stereo_tpu/pipeline/runner.py``).

``extract_config_from_camera``, config/camera validation,
``run_depth_estimation_pipeline`` with hooks on a thread pool,
``run_depth_estimation_pipeline_batched``, which groups frames into
fixed-size batches for ``process_batch``, and
``run_depth_estimation_pipeline_evaluation`` with the
``0 < gt <= max_disparity`` mask.

The runner does not wait for the device itself: the hooks copy their
tensors to the host on the pool's threads (``hooks.to_host``), so hook I/O
overlaps the next frames' device work.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..core.config import PipelineConfig
from .camera.camera import Camera, EvaluationCamera
from .depth_pipeline import DepthEstimationPipeline, DepthEstimationPipelineContext
from .hooks import DepthEstimationPipelineHook
from .metrics import DepthEstimationPipelineMetric


def extract_config_from_camera(camera: Camera) -> PipelineConfig:
    min_disparity, max_disparity = camera.get_disparity_boundaries()
    return PipelineConfig(image_shape=camera.get_image_shape(),
                          min_disparity=min_disparity,
                          max_disparity=max_disparity)


def validate_pipeline_config_wrt_camera(config: PipelineConfig,
                                        camera: Camera) -> None:
    if tuple(camera.get_image_shape()) != tuple(config.image_shape):
        raise RuntimeError(
            "Incompatible image shapes between pipeline configuration and "
            f"camera. Pipeline expects: {config.image_shape} but camera "
            f"provides: {camera.get_image_shape()}.")


def reduce_metrics(metrics_results: Dict[str, List[float]],
                   reduction: str = "mean") -> Dict[str, float]:
    ops = {"mean": lambda x: sum(x) / len(x), "sum": sum}
    return {key: ops[reduction](value) for key, value in metrics_results.items()}


def run_depth_estimation_pipeline(
        camera: Camera, pipeline: DepthEstimationPipeline,
        hooks: Optional[Iterable[DepthEstimationPipelineHook]] = None) -> None:
    """Stream every camera frame through the pipeline, invoking hooks on a
    host thread pool so artifact IO overlaps device compute."""
    hooks = list(hooks) if hooks else []
    config = pipeline.get_configuration()
    validate_pipeline_config_wrt_camera(config, camera)

    n_workers = max(1, min(len(hooks), (os.cpu_count() or 2) - 1))
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        list(pool.map(lambda h: h.on_pipeline_start(), hooks))

        pending = []
        for frame_index, (left, right) in enumerate(camera.stream_image_pairs()):
            result = pipeline.process(left, right)
            context = DepthEstimationPipelineContext(
                disparity_map=result.disparity_map,
                left_image=result.left_image,
                right_image=result.right_image,
                config=config,
                frame_index=frame_index)
            still_pending = []
            for f in pending:
                if f.done():
                    f.result()   # done: surface hook exceptions instead of dropping them
                else:
                    still_pending.append(f)
            pending = still_pending
            pending += [pool.submit(DepthEstimationPipelineHook.invoke_in_context,
                                    hook, context) for hook in hooks]
        for f in pending:
            f.result()   # bounded by the hook's own work (a file written)
        list(pool.map(lambda h: h.on_pipeline_end(), hooks))


def run_depth_estimation_pipeline_batched(
        camera: Camera, pipeline: DepthEstimationPipeline, batch_size: int,
        hooks: Optional[Iterable[DepthEstimationPipelineHook]] = None) -> None:
    """Batched variant: frames are grouped into (N, 3, H, W) batches and run
    through the batched/sharded engine; hooks still see per-frame contexts."""
    hooks = list(hooks) if hooks else []
    config = pipeline.get_configuration()
    validate_pipeline_config_wrt_camera(config, camera)

    def flush(batch_lr, start_index, pool):
        lefts = np.stack([l for l, _ in batch_lr])
        n_with_right = sum(r is not None for _, r in batch_lr)
        if 0 < n_with_right < len(batch_lr):
            raise RuntimeError(
                f"Mixed batch: {n_with_right}/{len(batch_lr)} frames carry a "
                "real right view. Batches must be all-real or all-synthesized "
                "— split the stream or use the unbatched runner.")
        rights = ([r for _, r in batch_lr] if n_with_right else None)
        result = pipeline.process_batch(
            lefts, np.stack(rights) if rights else None)
        futures = []
        for i in range(len(batch_lr)):
            context = DepthEstimationPipelineContext(
                disparity_map=result.disparity_map[i],
                left_image=result.left_image[i],
                right_image=result.right_image[i],
                config=config, frame_index=start_index + i)
            futures += [pool.submit(DepthEstimationPipelineHook.invoke_in_context,
                                    hook, context) for hook in hooks]
        return futures

    n_workers = max(1, min(max(len(hooks), 1), (os.cpu_count() or 2) - 1))
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        list(pool.map(lambda h: h.on_pipeline_start(), hooks))
        batch, start, pending = [], 0, []
        for left, right in camera.stream_image_pairs():
            batch.append((left, right))
            if len(batch) == batch_size:
                pending += flush(batch, start, pool)
                start += len(batch)
                batch = []
        if batch:
            pending += flush(batch, start, pool)
        for f in pending:
            f.result()   # bounded by the hook's own work (a file written)
        list(pool.map(lambda h: h.on_pipeline_end(), hooks))


def run_depth_estimation_pipeline_evaluation(
        camera: EvaluationCamera, pipeline: DepthEstimationPipeline,
        metrics: Optional[Iterable[DepthEstimationPipelineMetric]] = None,
        reduction: str = "mean", verbose: bool = True) -> Dict[str, float]:
    """Evaluate against ground truth with the reference's mask
    ``0 < gt <= max_disparity`` (``runner.py:85``)."""
    metrics = list(metrics) if metrics else []
    config = pipeline.get_configuration()
    validate_pipeline_config_wrt_camera(config, camera)
    max_disp = config.max_disparity

    results: Dict[str, List[float]] = {m.name(): [] for m in metrics}
    for frame_index, (left, right, gt) in enumerate(
            camera.stream_image_pairs_with_gt_disparity()):
        output = pipeline.process(left, right)
        gt = np.asarray(gt)
        mask = (gt <= max_disp) & (gt > 0)
        for metric in metrics:
            results[metric.name()].append(
                metric.process(output.disparity_map, gt, mask))
        if verbose:
            print(f"Processed frame {frame_index}.")
    return reduce_metrics(results, reduction)
