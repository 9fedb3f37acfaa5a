"""The port's single-view pipeline against ``stereo_tpu``'s.

Both pipelines load the committed Deep3D checkpoint themselves and run it
at its native 384x1280 shape; the output shape here is 96x320 with
disparities 1..16, the range Deep3D's 65 shift channels cover at that
width (64 * 320 / 1280).  The synthesized right view is not integer-valued,
so near-tie winner flips are expected: the contract is at least 99% of
pixels within 0.5 px.
"""

import numpy as np
import pytest
import torch

from stereo_tpu.core.config import PipelineConfig as JaxPipelineConfig
from stereo_tpu.pipeline.depth_pipeline import (
    DepthEstimationPipeline as JaxPipeline)

from stereo_tpu_torch.core.config import PipelineConfig
from stereo_tpu_torch.pipeline import DepthEstimationPipeline

SHAPE = (96, 320)
MAX_DISPARITY = 16


@pytest.fixture(scope="module")
def pipelines():
    jax_pipe = JaxPipeline(JaxPipelineConfig(image_shape=SHAPE,
                                             max_disparity=MAX_DISPARITY))
    pipe = DepthEstimationPipeline(
        PipelineConfig(image_shape=SHAPE, max_disparity=MAX_DISPARITY),
        device="cpu")
    return jax_pipe, pipe


def frames(n, seed=0):
    """Smooth seeded frames (a textured scene, not white noise)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (n, 3, SHAPE[0] // 4, SHAPE[1] // 4))
    up = np.repeat(np.repeat(base, 4, axis=2), 4, axis=3)
    noise = rng.uniform(-20, 20, up.shape)
    return np.clip(np.round(up + noise), 0, 255).astype(np.float32)


def frac_within(got, want, px=0.5):
    return float(np.mean(np.abs(np.asarray(got) - np.asarray(want)) <= px))


def test_process_matches_jax(pipelines):
    jax_pipe, pipe = pipelines
    left = frames(1)[0]
    want = np.asarray(jax_pipe.process(left).disparity_map)
    result = pipe.process(left)
    assert result.disparity_map.shape == SHAPE
    assert result.right_image.shape == (3, *SHAPE)
    assert bool(torch.isfinite(result.disparity_map).all())
    assert frac_within(result.disparity_map.numpy(), want) >= 0.99


def test_process_batch_matches_jax(pipelines):
    jax_pipe, pipe = pipelines
    lefts = frames(2, seed=1)
    want = np.asarray(jax_pipe.process_batch(lefts).disparity_map)
    got = pipe.process_batch(lefts).disparity_map
    assert got.shape == (2, *SHAPE)
    for i in range(2):
        assert frac_within(got[i].numpy(), want[i]) >= 0.99


def test_stereo_pair_and_stage_times(pipelines):
    _, pipe = pipelines
    left = frames(1, seed=2)[0]
    right = np.roll(left, -3, axis=-1)
    disparity = pipe.process(left, right).disparity_map.numpy()
    assert np.median(disparity[:, 16:-16]) == pytest.approx(3.0, abs=0.5)
    times = pipe.stage_times()
    assert set(times) == {"right_view_generation", "stereo_matching"}
    assert all(v > 0 for v in times.values())


def test_unported_backends_raise():
    from stereo_tpu_torch.core.config import MeshConfig

    with pytest.raises(NotImplementedError, match="not ported"):
        DepthEstimationPipeline(
            PipelineConfig(mesh=MeshConfig(data=2)), device="cpu")


def test_coverage_guard_warns():
    from stereo_tpu_torch.synthesis import RightViewSynthesis

    synthesis = RightViewSynthesis(output_shape=(48, 96), seed=0,
                                   model_full_shape=(128, 256),
                                   model_down_shape=(32, 64), device="cpu")
    pipe = DepthEstimationPipeline(
        PipelineConfig(image_shape=(48, 96), max_disparity=64),
        synthesis=synthesis, device="cpu")
    with pytest.warns(UserWarning, match="asks for disparities up to 64"):
        pipe.process(np.zeros((3, 48, 96), np.float32))
