"""The port's cost volumes, regression head and Flax-semantics convolutions
against ``stereo_tpu``, on the same numpy-seeded inputs.

The port keeps features NCHW and volumes NCDHW; the JAX package keeps
NHWC / NDHWC, so each comparison permutes the port's output to the JAX
layout.  The Pallas ``gwc_volume`` kernel runs in interpret mode, as the
JAX package's own tests run it on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu.models import cost_volumes as jcv
from stereo_tpu.models.layers import upsample_trilinear as jax_trilinear
from stereo_tpu.ops.conv3d import conv3d_mxu, conv3d_native
from stereo_tpu.ops.conv3d import deconv3d_parity as jax_deconv3d_parity
from stereo_tpu.ops.pallas.gwc_volume import build_gwc_volume_pallas

from stereo_tpu_torch.models import cost_volumes as cv
from stereo_tpu_torch.models.layers import upsample_trilinear
from stereo_tpu_torch.ops.conv3d import (conv_same, deconv3d_parity,
                                         pack_deconv3d_weight, same_padding)
from stereo_tpu_torch.ops.cuda import LAUNCHES, gwc_volume, gwc_volume_plain


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def features(rng, n, h, w, c):
    """NHWC features, ReLU'd as real features are."""
    return np.maximum(rng.standard_normal((n, h, w, c)), 0).astype(np.float32)


# (N, H, W, C, D, G): the shapes of tests/test_models.py and GwcNet's
# width (C=320, G=40) at a small image.
GWC_SHAPES = [(2, 8, 24, 40, 12, 10), (1, 6, 40, 320, 16, 40)]


@pytest.mark.parametrize("shape", GWC_SHAPES, ids=str)
def test_gwc_volume_matches_jax_builds(shape):
    n, h, w, c, d, g = shape
    rng = np.random.default_rng(7)
    left, right = features(rng, n, h, w, c), features(rng, n, h, w, c)
    want = np.asarray(jcv.build_gwc_volume(jnp.asarray(left),
                                           jnp.asarray(right), d, g))
    want_pallas = np.asarray(build_gwc_volume_pallas(
        jnp.asarray(left), jnp.asarray(right), d, g, interpret=True))
    before = dict(LAUNCHES)
    for fn in (gwc_volume_plain, gwc_volume, cv.build_gwc_volume):
        got = fn(nchw(left), nchw(right), d, g)
        assert got.shape == (n, g, d, h, w) and got.dtype == torch.float32
        got = got.permute(0, 2, 3, 4, 1).numpy()          # NDHWG
        # Same products, summed in another order: float32 rounding.  Seen
        # 2.4e-7 at values up to 2.9.
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, want_pallas, rtol=0, atol=1e-5)
        for plane in range(d):                            # exactly 0 at w < d
            assert not got[:, plane, :, :plane].any()
    # The CPU branch runs the plain version and counts no launch.
    assert LAUNCHES == before


def test_gwc_volume_bf16_plain_rounds_a_float32_sum():
    rng = np.random.default_rng(8)
    left, right = (nchw(features(rng, 1, 4, 20, 32)).to(torch.bfloat16)
                   for _ in range(2))
    got = gwc_volume(left, right, 6, 4)
    assert got.dtype == torch.bfloat16
    want = gwc_volume_plain(left.float(), right.float(), 6, 4)
    assert torch.equal(got, want.to(torch.bfloat16))


def test_gwc_volume_rejects_what_it_does_not_take():
    x = torch.zeros((1, 8, 4, 6))
    with pytest.raises(ValueError, match="unsupported device"):
        gwc_volume(x.to("meta"), x.to("meta"), 2, 2)
    with pytest.raises(ValueError, match="do not split"):
        gwc_volume(x, x, 2, 3)
    with pytest.raises(ValueError, match="differs from left"):
        gwc_volume(x, x[..., :5], 2, 2)
    assert LAUNCHES["gwc_volume"] == 0


def test_groupwise_correlation():
    rng = np.random.default_rng(1)
    fa, fb = features(rng, 1, 4, 6, 8), features(rng, 1, 4, 6, 8)
    want = np.asarray(jcv.groupwise_correlation(jnp.asarray(fa),
                                                jnp.asarray(fb), 2))
    got = cv.groupwise_correlation(nchw(fa), nchw(fb), 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-6)


def test_concat_volume():
    rng = np.random.default_rng(2)
    left, right = features(rng, 2, 5, 12, 3), features(rng, 2, 5, 12, 3)
    want = np.asarray(jcv.build_concat_volume(jnp.asarray(left),
                                              jnp.asarray(right), 6))
    got = cv.build_concat_volume(nchw(left), nchw(right), 6)
    # A copy: exact.
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), want)


def test_interlaced_volume():
    rng = np.random.default_rng(3)
    left, right = features(rng, 1, 4, 10, 3), features(rng, 1, 4, 10, 3)
    want = np.asarray(jcv.build_interlaced_volume(jnp.asarray(left),
                                                  jnp.asarray(right), 5))
    got = cv.build_interlaced_volume(nchw(left), nchw(right), 5)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_disparity_regression():
    rng = np.random.default_rng(4)
    prob = rng.dirichlet(np.ones(12), (2, 5, 7)).transpose(0, 3, 1, 2)
    prob = prob.astype(np.float32)
    want = np.asarray(jcv.disparity_regression(jnp.asarray(prob), 12))
    got = cv.disparity_regression(torch.from_numpy(prob), 12)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# (D_l, H_l, W_l, D, H, W): the shapes of tests/test_models.py.
SOFT_ARGMIN_SHAPES = [(12, 8, 16, 48, 32, 64), (16, 6, 10, 64, 24, 40),
                      (1, 4, 4, 4, 8, 8)]


@pytest.mark.parametrize("shape", SOFT_ARGMIN_SHAPES, ids=str)
def test_upsampled_soft_argmin(shape):
    dl, hl, wl, D, H, W = shape
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, dl, hl, wl, 1)) * 3.0).astype(np.float32)
    want = np.asarray(jcv.upsampled_soft_argmin(jnp.asarray(x), (D, H, W)))
    logits = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))
    got = cv.upsampled_soft_argmin(logits, (D, H, W))
    # The same streaming expectation; resize weights and exponentials
    # rounded by two libraries.  Seen 1.1e-5 px.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # And the explicit composition it streams.
    full = upsample_trilinear(logits, (D, H, W))[:, 0]
    explicit = cv.disparity_regression(torch.softmax(full, dim=1), D)
    np.testing.assert_allclose(got.numpy(), explicit.numpy(), rtol=0,
                               atol=1e-4)


def test_upsample_trilinear():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 3, 4, 5, 2)).astype(np.float32)
    want = np.asarray(jax_trilinear(jnp.asarray(x), (6, 8, 10)))
    got = upsample_trilinear(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                             (6, 8, 10))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               rtol=0, atol=1e-5)


def test_same_padding_is_flax_not_torch():
    # Stride 2 on an even size pads (0, 1); stride 1 and dilation 2 (2, 2).
    assert same_padding((8, 10), (3, 3), 2, 1) == [(0, 1), (0, 1)]
    assert same_padding((7,), (3,), 2, 1) == [(1, 1)]
    assert same_padding((9,), (3,), 1, 2) == [(2, 2)]
    assert same_padding((8,), (1,), 2, 1) == [(0, 0)]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cout", [1, 8])
def test_conv_same_3d(stride, cout):
    """conv_same against both JAX 3-D convolutions: the plain one and the
    TPU reformulations (``conv3d_mxu``: shift-add at one output channel,
    chunked below 128), at an even depth."""
    rng = np.random.default_rng(stride * 10 + cout)
    x = rng.standard_normal((2, 6, 8, 10, 5)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 5, cout)).astype(np.float32)
    got = conv_same(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                    torch.from_numpy(w).permute(4, 3, 0, 1, 2), stride=stride)
    got = got.permute(0, 2, 3, 4, 1).numpy()
    for conv in (conv3d_native, conv3d_mxu):
        want = np.asarray(conv(jnp.asarray(x), jnp.asarray(w), stride))
        assert got.shape == want.shape
        # 135-term sums of unit normals in another order.  Seen 1.9e-5.
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_deconv3d_parity():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 4, 5, 6)).astype(np.float32)
    w = rng.standard_normal((4, 4, 4, 6, 5)).astype(np.float32)
    want = np.asarray(jax_deconv3d_parity(jnp.asarray(x), jnp.asarray(w)))
    got = deconv3d_parity(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                          pack_deconv3d_weight(torch.from_numpy(w)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               rtol=0, atol=1e-5)
