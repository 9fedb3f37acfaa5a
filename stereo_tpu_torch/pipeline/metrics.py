"""Evaluation metrics: D1, Threshold_t, MAE (port of
``stereo_tpu/pipeline/metrics.py``).

Masked means over the whole map: the mask weights each pixel and the mean
divides by the number of masked pixels (at least 1), so no boolean
indexing changes shapes.  Estimates, ground truth and masks may be numpy
arrays or tensors on any device.

The single-view (synthesized right view) D1 targets of the DNN backends,
on the JAX package's held-out synthetic scenes at 384x1280 / D 0..64
(``results/evaluation/evaluation_r05_native_protocol.json``): gwcnet
0.018, msnet3d 0.020, msnet2d 0.029, against 0.095 for the classical
matcher; with the real right view 0.0004, 0.0012, 0.0049 and 0.056.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import torch


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> float:
    weight = mask.to(values.dtype)
    return float((values * weight).sum() / weight.sum().clamp_min(1.0))


def _as_tensors(estimate, gt, mask):
    est = torch.as_tensor(estimate).float()
    return (est, torch.as_tensor(gt).to(est.device, torch.float32),
            torch.as_tensor(mask).to(est.device))


class DepthEstimationPipelineMetric(ABC):
    """A scalar metric over (estimate, ground truth, validity mask)."""

    @abstractmethod
    def process(self, disparity_estimate, disparity_gt, mask) -> float:
        ...

    @abstractmethod
    def name(self) -> str:
        ...


class D1Metric(DepthEstimationPipelineMetric):
    """KITTI D1: share of masked pixels with error > 3 px AND > 5% of gt."""

    def process(self, disparity_estimate, disparity_gt, mask) -> float:
        est, gt, m = _as_tensors(disparity_estimate, disparity_gt, mask)
        err = (est - gt).abs()
        return _masked_mean(((err > 3.0) & (err / gt.abs() > 0.05)).float(), m)

    def name(self) -> str:
        return "D1"


class ThresholdMetric(DepthEstimationPipelineMetric):
    """Share of masked pixels with absolute error > threshold."""

    def __init__(self, threshold: float):
        self._threshold = float(threshold)

    def process(self, disparity_estimate, disparity_gt, mask) -> float:
        est, gt, m = _as_tensors(disparity_estimate, disparity_gt, mask)
        return _masked_mean(((est - gt).abs() > self._threshold).float(), m)

    def name(self) -> str:
        return f"Threshold_{int(self._threshold)}"


class MAEMetric(DepthEstimationPipelineMetric):
    """Mean absolute disparity error over masked pixels."""

    def process(self, disparity_estimate, disparity_gt, mask) -> float:
        est, gt, m = _as_tensors(disparity_estimate, disparity_gt, mask)
        return _masked_mean((est - gt).abs(), m)

    def name(self) -> str:
        return "MAE"


def default_metrics():
    """The six metrics of the evaluation: D1, Threshold_1/2/3/5, MAE."""
    return [D1Metric(), ThresholdMetric(1), ThresholdMetric(2),
            ThresholdMetric(3), ThresholdMetric(5), MAEMetric()]
