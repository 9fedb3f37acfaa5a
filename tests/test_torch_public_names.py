"""The last public names of ``stereo_tpu`` the port lacked, against the JAX
package on seeded numpy inputs: ``ops.grayscale_gradient``,
``ops.disparity_shift_stack`` and the native runtime's ``available()`` and
``build_error()``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu.ops.imageops import grayscale_gradient as jax_gradient
from stereo_tpu.ops.shift_stack import (
    disparity_shift_stack as jax_shift_stack)

from stereo_tpu_torch import _native, ops

import torch_threads

torch_threads.take_worker_share()


@pytest.mark.parametrize("shape", [(5, 7), (24, 40)], ids=str)
def test_grayscale_gradient_matches_jax(shape):
    """Sobel magnitude: two 3x3 correlations in two conv libraries, then a
    square root; float32 rounding of sums up to 4 * 255 (atol 1e-3)."""
    image = np.random.default_rng(1).uniform(0, 255, shape).astype(
        np.float32)
    want = np.asarray(jax_gradient(jnp.asarray(image)))
    got = ops.grayscale_gradient(torch.from_numpy(image))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("d_range", [(0, 4), (-3, 2), (-5, -1)], ids=str)
def test_disparity_shift_stack_matches_jax(d_range):
    """Shifts move samples without arithmetic: exactly equal."""
    x = np.random.default_rng(2).uniform(0, 255, (2, 3, 4, 9)).astype(
        np.float32)
    want = np.asarray(jax_shift_stack(jnp.asarray(x), *d_range))
    got = ops.disparity_shift_stack(torch.from_numpy(x), *d_range)
    assert got.shape == (2, d_range[1] - d_range[0] + 1, 3, 4, 9)
    np.testing.assert_array_equal(got.numpy(), want)


def test_native_reports_its_build(monkeypatch, tmp_path):
    """``available()`` and ``build_error()`` report the build: True and
    None here, where g++ and zlib are installed; False and the compiler's
    message when the build fails (a source that does not compile)."""
    assert _native.available() is True
    assert _native.build_error() is None
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "SOURCE", str(bad))
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_native, "_library", None)
    monkeypatch.setattr(_native, "_build_error", None)
    assert _native.available() is False
    assert "native build failed" in _native.build_error()
