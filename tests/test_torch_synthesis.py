"""The port's Deep3D right-view synthesis against ``stereo_tpu``.

The committed checkpoint (``data/checkpoints/deep3d.npz``) is read once per
module with numpy and handed to both packages: as a Flax variables tree to
the JAX model and through ``deep3d_state_dict_from_flax`` to the port.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu.models import Deep3D as JaxDeep3D
from stereo_tpu.ops.conv3d import deconv2d_parity as jax_deconv2d_parity
from stereo_tpu.ops.pallas.blend import upsample_blend as jax_upsample_blend
from stereo_tpu.ops.shift_stack import (
    weighted_shift_sum as jax_weighted_shift_sum)
from stereo_tpu.synthesis import RightViewSynthesis as JaxRightViewSynthesis
from stereo_tpu.utils.paths import DEEP3D_CHECKPOINT_DIR

from stereo_tpu_torch.models import Deep3D, deep3d_state_dict_from_flax
from stereo_tpu_torch.models.layers import (deconv2d_parity,
                                            pack_parity_weight)
from stereo_tpu_torch.ops import weighted_shift_sum
from stereo_tpu_torch.ops.cuda import upsample_blend
from stereo_tpu_torch.synthesis import RightViewSynthesis

import torch_threads

torch_threads.take_worker_share()


@pytest.fixture(scope="module")
def checkpoint():
    """(numpy float32 arrays by Flax key, Flax variables tree)."""
    with np.load(DEEP3D_CHECKPOINT_DIR + ".npz") as data:
        arrays = {k: data[k].astype(np.float32) for k in data.files
                  if not k.startswith("__meta__")}
    variables: dict = {}
    for key, arr in arrays.items():
        parts = re.findall(r"\['([^']+)'\]", key)
        node = variables
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(arr)
    return arrays, variables


def _with_bf16_ff(variables):
    """The JAX inference wrapper's bf16 cast of the global branch's two
    Dense kernels."""
    def cast(path, leaf):
        keys = [getattr(p, "key", None) for p in path]
        if ("FeedForwardBranch_0" in keys and keys[-1] == "kernel"
                and any(k in ("Dense_0", "Dense_1") for k in keys)):
            return jnp.asarray(leaf, jnp.bfloat16)
        return leaf
    return jax.tree_util.tree_map_with_path(cast, variables)


@pytest.mark.parametrize("s", [2, 4, 16])
def test_deconv2d_parity(s):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, 3, 5, 6)).astype(np.float32)       # NHWC
    w = rng.standard_normal((2 * s, 2 * s, 6, 4)).astype(np.float32)
    want = np.asarray(jax_deconv2d_parity(jnp.asarray(x), jnp.asarray(w), s))
    got = deconv2d_parity(torch.from_numpy(x).permute(0, 3, 1, 2),
                          pack_parity_weight(torch.from_numpy(w), s), s)
    # Same products summed by two conv implementations: float rounding.
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


def test_weighted_shift_sum():
    rng = np.random.default_rng(3)
    weights = rng.dirichlet(np.ones(9), (2, 6, 20)).astype(np.float32)
    weights = np.ascontiguousarray(weights.transpose(0, 3, 1, 2))
    view = rng.uniform(0, 255, (2, 3, 6, 20)).astype(np.float32)
    want = np.asarray(jax_weighted_shift_sum(jnp.asarray(weights),
                                             jnp.asarray(view)))
    got = weighted_shift_sum(torch.from_numpy(weights), torch.from_numpy(view))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("scale,h,w,num_d,batch", [
    (4, 16, 32, 9, 1),
    (4, 48, 64, 65, 1),
    (2, 16, 32, 7, 2),
    # Narrower than D - 1 columns: every shift window runs past the edge.
    (4, 16, 48, 65, 1),
])
def test_upsample_blend_plain_matches_jax_kernel(scale, h, w, num_d, batch):
    rng = np.random.default_rng(5)
    prob = rng.dirichlet(np.ones(num_d), (batch, h // scale, w // scale))
    prob = np.ascontiguousarray(prob.astype(np.float32).transpose(0, 3, 1, 2))
    view = rng.uniform(0, 255, (batch, 3, h, w)).astype(np.float32)
    want = np.asarray(jax_upsample_blend(jnp.asarray(prob),
                                         jnp.asarray(view), scale))
    got = upsample_blend(torch.from_numpy(prob), torch.from_numpy(view), scale)
    # The tolerance of the JAX kernel's own test (tests/test_pallas.py).
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("ff", ["float32", "bfloat16"])
def test_deep3d_prob_volume_low(checkpoint, ff):
    arrays, variables = checkpoint
    down = np.random.default_rng(0).uniform(0, 1, (1, 3, 96, 320)).astype(
        np.float32)
    jax_ff = None if ff == "float32" else jnp.bfloat16
    model = JaxDeep3D(ff_dense_dtype=jax_ff)
    if jax_ff is not None:
        variables = _with_bf16_ff(variables)
    want = np.asarray(jax.jit(functools.partial(
        model.apply, method=JaxDeep3D.prob_volume_low))(variables,
                                                        jnp.asarray(down)))

    ported = Deep3D(ff_dense_dtype=None if ff == "float32" else torch.bfloat16)
    ported.load_state_dict(deep3d_state_dict_from_flax(arrays))
    if ff == "bfloat16":
        branch = ported.DisparityEstimationNetwork_0.FeedForwardBranch_0
        branch.Dense_0.to(torch.bfloat16)
        branch.Dense_1.to(torch.bfloat16)
    with torch.no_grad():
        got = ported.eval().prob_volume_low(torch.from_numpy(down)).numpy()
    assert got.shape == want.shape == (1, 65, 96, 320)
    # float32: the same network in two conv libraries; 16 layers of
    # reassociated float32 sums stay within 1e-5 on probabilities (seen:
    # 2.4e-6).  bf16 global branch: the two frameworks round its products
    # and bias adds to bf16 (8 bits) at different points, which moves
    # the branch logits by about 2^-8 relative; on the probabilities that
    # is below 3e-3 (seen: 7.6e-4).
    atol = 1e-5 if ff == "float32" else 3e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("ff", ["float32", "bfloat16"])
def test_right_view_synthesis_process(checkpoint, ff):
    arrays, variables = checkpoint
    left = np.round(np.random.default_rng(1).uniform(
        0, 255, (3, 384, 1280))).astype(np.float32)
    jax_rvs = JaxRightViewSynthesis(variables=variables, ff_weights_dtype=ff)
    want = np.asarray(jax_rvs.process(jnp.asarray(left)))
    rvs = RightViewSynthesis(state_dict=deep3d_state_dict_from_flax(arrays),
                             ff_weights_dtype=ff, device="cpu")
    got = rvs.process(torch.from_numpy(left)).numpy()
    assert got.shape == (3, 384, 1280)
    # 0..255 views.  float32: float rounding of the network and of the
    # 65-way blend (seen: 2.7e-4).  bf16 global branch: probabilities move
    # by up to ~1e-3 (see above), a blended pixel by far less than one grey
    # level (seen: 0.016).
    atol = 2e-3 if ff == "float32" else 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_seeded_weights_are_reproducible():
    rvs = RightViewSynthesis(output_shape=(48, 96), seed=0,
                             model_full_shape=(128, 256),
                             model_down_shape=(32, 64), device="cpu")
    left = np.random.default_rng(2).integers(0, 256, (2, 3, 48, 96)).astype(
        np.float32)
    out = rvs.process_batch(left)
    assert out.shape == (2, 3, 48, 96)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 255.0
    again = RightViewSynthesis(output_shape=(48, 96), seed=0,
                               model_full_shape=(128, 256),
                               model_down_shape=(32, 64), device="cpu")
    np.testing.assert_array_equal(again.process_batch(left).numpy(),
                                  out.numpy())


def test_bfloat16_compute_tracks_float32():
    """``compute_dtype="bfloat16"`` runs the whole network in bf16 (about
    three decimal digits on the 0..1 view before the 0..255 rescale), so
    the view stays within one grey level of the float32 one (seen: 0.067
    with these seeded weights)."""
    left = np.random.default_rng(4).integers(0, 256, (3, 48, 96)).astype(
        np.float32)
    outs = {}
    for dtype in ("float32", "bfloat16"):
        rvs = RightViewSynthesis(output_shape=(48, 96), seed=1,
                                 model_full_shape=(128, 256),
                                 model_down_shape=(32, 64),
                                 compute_dtype=dtype, device="cpu")
        outs[dtype] = rvs.process(left).numpy()
    assert outs["bfloat16"].dtype == np.float32
    np.testing.assert_allclose(outs["bfloat16"], outs["float32"], rtol=0,
                               atol=1.0)
