"""GwcNet at ``max_disparity=192`` (the JAX package's default depth), the
port's backend against the JAX backend on the committed checkpoint.

The other GwcNet tests run at depth 32-64; at 192 the volume has 48
planes at quarter resolution, the soft-argmin 192.  Float32 must agree to
float rounding.  In bfloat16 the two frameworks round at other points, and
at this depth the two bf16 arms differ by up to 3.1 px (0.276 px at depth
64), so the depth-64 tolerance (max 0.5 px, mean 0.02 px against JAX's
bf16) does not carry over: the port's bf16 is instead held to JAX's
float32 answer no worse than JAX's own bf16 arm is.
"""

import numpy as np
import pytest
import torch

from stereo_tpu.pipeline.backends import (
    DnnStereoMatchingBackend as JaxDnnBackend)
from test_torch_dnn import textured_pair

from stereo_tpu_torch.pipeline import DnnStereoMatchingBackend

import torch_threads

torch_threads.take_worker_share()

SHAPE = (64, 256)
DEPTH = 192


@pytest.fixture(scope="module")
def pair():
    return textured_pair(*SHAPE, 5)


@pytest.fixture(scope="module")
def jax_float32(pair):
    return np.asarray(JaxDnnBackend("gwcnet", SHAPE, max_disparity=DEPTH)
                      .process(*pair))


def error_stats(disparity, reference):
    diff = np.abs(np.asarray(disparity, np.float64) - reference)
    return diff.max(), diff.mean(), float((diff > 0.5).mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gwcnet_depth192_matches_jax(dtype, pair, jax_float32):
    backend = DnnStereoMatchingBackend("gwcnet", SHAPE, max_disparity=DEPTH,
                                       compute_dtype=dtype, device="cpu")
    assert backend.weights.endswith("gwcnet.npz")
    got = backend.process(*pair)
    assert got.dtype == torch.float32 and got.shape == SHAPE
    assert np.isfinite(got.numpy()).all()
    max_err, mean_err, share = error_stats(got.numpy(), jax_float32)
    if dtype == "float32":
        assert max_err <= 1e-3          # seen 1.4e-4 px
        return
    jax_bf16 = JaxDnnBackend("gwcnet", SHAPE, max_disparity=DEPTH,
                             compute_dtype="bfloat16").process(*pair)
    _, jax_mean, jax_share = error_stats(jax_bf16, jax_float32)
    # Seen: port 0.066 px mean, 4.4% of pixels off by > 0.5 px; JAX's bf16
    # 0.112 px, 6.9%.  The port's float32 lands 3.2e-6 px from JAX's on
    # average, so a mean over 1e-3 px shows this arm did run in bf16.
    assert backend.compute_dtype == torch.bfloat16
    assert 1e-3 < mean_err <= jax_mean
    assert share <= jax_share
