"""The port's fused single-view engine and split Deep3D inference against
``stereo_tpu``'s, on the CPU at the JAX package's own test configuration
(``tests/test_synthesis.py``): 48x96 frames, disparities 0..15, Deep3D at
128x256 / 32x64 with the fresh Flax variables of ``PRNGKey(0)``, carried
into the port by ``deep3d_state_dict_from_flax``.  Inputs are seeded numpy.

Also here: the pipeline's routing (``_fused_single_view`` is None on the
CPU in both packages), the synthesis warmup, the module CLI with
``--device cpu`` and fresh Deep3D weights when no checkpoint is present.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu.core.config import MatchingConfig as JaxMatchingConfig
from stereo_tpu.core.config import PipelineConfig as JaxPipelineConfig
from stereo_tpu.models import Deep3D as JaxDeep3D
from stereo_tpu.pipeline.depth_pipeline import (
    DepthEstimationPipeline as JaxPipeline)
from stereo_tpu.pipeline.single_view import (
    FusedSingleViewEngine as JaxFusedSingleViewEngine)
from stereo_tpu.synthesis import RightViewSynthesis as JaxRightViewSynthesis
from stereo_tpu.synthesis.right_view_synthesis import (
    fused_blend_tail as jax_fused_blend_tail,
    synthesize_net_batch as jax_synthesize_net_batch)

from stereo_tpu_torch.core.config import MatchingConfig, PipelineConfig
from stereo_tpu_torch.matching.classical import ClassicalStereoEngine
from stereo_tpu_torch.models import Deep3D, deep3d_state_dict_from_flax
from stereo_tpu_torch.models import _NPZ_META_PREFIX
from stereo_tpu_torch.pipeline import DepthEstimationPipeline
from stereo_tpu_torch.pipeline.single_view import FusedSingleViewEngine
from stereo_tpu_torch.synthesis import RightViewSynthesis
from stereo_tpu_torch.synthesis import right_view_synthesis as rvs_module
from stereo_tpu_torch.synthesis.right_view_synthesis import (
    fused_blend_tail, synthesize_net_batch)
from stereo_tpu_torch.utils import png
from stereo_tpu_torch.utils.png import encode_png

import torch_threads

torch_threads.take_worker_share()

SHAPE = (48, 96)
FULL, DOWN = (128, 256), (32, 64)
MATCHING = dict(height=48, width=96, downscale_factor=2, min_disparity=0,
                max_disparity=15, cost_patch_radius=1, sad_patch_radius=2,
                threshold=5, small_mbm_radius=1, mid_mbm_radius=1,
                large_mbm_radius=2)


@pytest.fixture(scope="module")
def variables():
    """JAX's fresh small-model variables (``PRNGKey(0)``) and the port's
    state dict of the same values."""
    full = np.zeros((1, 3, *FULL), np.float32)
    down = np.zeros((1, 3, *DOWN), np.float32)
    # Jitted: one compile instead of Flax's op-by-op init.
    variables = jax.jit(lambda key: JaxDeep3D().init(
        key, full, down, train=False))(jax.random.PRNGKey(0))
    arrays = {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf
              in jax.tree_util.tree_flatten_with_path(variables)[0]}
    return variables, deep3d_state_dict_from_flax(arrays)


@pytest.fixture(scope="module")
def syntheses(variables):
    jax_vars, state = variables
    jax_rvs = JaxRightViewSynthesis(output_shape=SHAPE, variables=jax_vars,
                                    model_full_shape=FULL,
                                    model_down_shape=DOWN)
    rvs = RightViewSynthesis(output_shape=SHAPE, state_dict=state,
                             model_full_shape=FULL, model_down_shape=DOWN,
                             device="cpu")
    return jax_rvs, rvs


def frames(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 3, *SHAPE)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_batch(syntheses):
    """Two seeded frames through JAX's ``FusedSingleViewEngine``:
    ``(left, disparity, right)``."""
    jax_rvs, _ = syntheses
    left = frames(2, 7)
    disparity, right = JaxFusedSingleViewEngine(
        JaxMatchingConfig(**MATCHING), jax_rvs).process_batch(left)
    return left, np.asarray(disparity), np.asarray(right)


def test_engine_batch_matches_jax(syntheses, jax_batch):
    """Batch 2.  Right view within 0.05 of JAX's (the JAX engine's tail is
    the interpret-mode Pallas blend, the port's the plain blend: float
    rounding).  The port's disparity equals the port's classical engine on
    the port's own right view (atol 1e-5: the same stages), and at least
    99% of its pixels lie within 0.5 px of JAX's (near-tie winners may
    flip on a right view that differs in the last bits)."""
    _, rvs = syntheses
    left, jax_disp, jax_right = jax_batch
    engine = FusedSingleViewEngine(MatchingConfig(**MATCHING), rvs)
    disparity, right = engine.process_batch(left)
    assert disparity.shape == (2, *SHAPE) and right.shape == (2, 3, *SHAPE)
    assert engine.graphs_captured == 0          # the CPU runs eagerly
    np.testing.assert_allclose(right.numpy(), jax_right, rtol=0, atol=0.05)
    own = ClassicalStereoEngine(MatchingConfig(**MATCHING),
                                device="cpu").compute_disparity_maps(
        left, right.numpy())
    np.testing.assert_allclose(disparity.numpy(), own.numpy(), rtol=0,
                               atol=1e-5)
    within = np.abs(disparity.numpy() - jax_disp) <= 0.5
    assert within.mean() >= 0.99


def test_engine_single_frame_process(syntheses, jax_batch):
    """``process`` on one (3, H, W) frame against JAX's engine on the same
    frame (its batch of two, which JAX maps frame by frame): the same
    gates as the batch."""
    _, rvs = syntheses
    left, jax_disp, jax_right = jax_batch
    disparity, right = FusedSingleViewEngine(MatchingConfig(**MATCHING),
                                             rvs).process(left[1])
    assert disparity.shape == SHAPE and right.shape == (3, *SHAPE)
    np.testing.assert_allclose(right.numpy(), jax_right[1], rtol=0,
                               atol=0.05)
    within = np.abs(disparity.numpy() - jax_disp[1]) <= 0.5
    assert within.mean() >= 0.99


@pytest.mark.parametrize("shape", [(2, 1, *SHAPE), (2, 3, 48, 64),
                                   (3, *SHAPE)])
def test_engine_refuses_other_frame_shapes(syntheses, shape):
    """A grey batch, another width or a missing batch axis raises the
    eager engine's ``ValueError`` instead of being broadcast."""
    _, rvs = syntheses
    engine = FusedSingleViewEngine(MatchingConfig(**MATCHING), rvs)
    with pytest.raises(ValueError, match="engine built for"):
        engine.process_batch(np.zeros(shape, np.float32))


def test_split_inference_matches_jax(variables):
    """``synthesize_net_batch``: prob_low within 1e-5 (the same network in
    two conv libraries) and the normalised view equal to float rounding.
    ``fused_blend_tail`` on JAX's own network outputs: within 2e-3 of JAX's
    interpret-mode Pallas tail (the blend kernel's test tolerance, 2e-4 on
    the 0..1 view, times 255 for the rescale, and an antialiased resize
    that averages it).  The two halves compose to ``process_batch``."""
    jax_vars, state = variables
    model = Deep3D(DOWN)
    model.load_state_dict(state)
    model.eval()
    left = np.random.default_rng(3).integers(
        0, 256, (1, 3, *FULL)).astype(np.float32)
    jax_prob, jax_full = jax.jit(functools.partial(
        jax_synthesize_net_batch, JaxDeep3D(), full_shape=FULL,
        down_shape=DOWN))(jax_vars, jnp.asarray(left))
    prob, full = synthesize_net_batch(model, torch.from_numpy(left), FULL,
                                      DOWN)
    assert prob.shape == (1, 65, 32, 64) and full.shape == (1, 3, *FULL)
    np.testing.assert_allclose(prob.numpy(), np.asarray(jax_prob), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(full.numpy(), np.asarray(jax_full), rtol=0,
                               atol=1e-6)
    want = np.asarray(jax.jit(functools.partial(
        jax_fused_blend_tail, scale=4, output_shape=SHAPE,
        full_shape=FULL))(jax_prob, jax_full))
    got = fused_blend_tail(torch.from_numpy(np.asarray(jax_prob)),
                           torch.from_numpy(np.asarray(jax_full)), 4, SHAPE,
                           FULL)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
    rvs = RightViewSynthesis(output_shape=SHAPE, state_dict=state,
                             model_full_shape=FULL, model_down_shape=DOWN,
                             device="cpu")
    halves = synthesize_net_batch(rvs.model, torch.from_numpy(left), FULL,
                                  DOWN)
    np.testing.assert_array_equal(
        rvs.process_batch(left).numpy(),
        fused_blend_tail(*halves, 4, SHAPE, FULL).numpy())


def test_fused_single_view_is_none_on_the_cpu(syntheses):
    """Both packages route the CPU's single view around the fused engine:
    JAX's needs a TPU, the port's a CUDA device."""
    jax_rvs, rvs = syntheses
    assert not jax_rvs.split_inference and not rvs.split_inference
    jax_pipe = JaxPipeline(JaxPipelineConfig(image_shape=SHAPE,
                                             max_disparity=15),
                           synthesis=jax_rvs)
    pipe = DepthEstimationPipeline(PipelineConfig(image_shape=SHAPE,
                                                  max_disparity=15),
                                   synthesis=rvs, device="cpu")
    assert jax_pipe._fused_single_view() is None
    assert pipe._fused_single_view() is None
    result = pipe.process(frames(1, 9)[0])
    assert result.disparity_map.shape == SHAPE


def test_warmups_run_on_the_cpu(syntheses):
    _, rvs = syntheses
    rvs.warmup()
    engine = FusedSingleViewEngine(MatchingConfig(**MATCHING), rvs)
    engine.warmup()
    assert engine.graphs_captured == 0
    ClassicalStereoEngine(MatchingConfig(**MATCHING), device="cpu").warmup()
    built = RightViewSynthesis(output_shape=SHAPE, seed=0, warmup=True,
                               model_full_shape=FULL, model_down_shape=DOWN,
                               device="cpu")
    assert not built.split_inference


def test_missing_default_checkpoint_builds_fresh_weights(monkeypatch,
                                                         tmp_path):
    """No checkpoint at the default path: fresh weights with a warning, as
    the JAX package initialises its model; an explicit missing path still
    raises in both packages."""
    monkeypatch.setattr(rvs_module, "DEEP3D_CHECKPOINT_DIR",
                        str(tmp_path / "deep3d"))
    with pytest.warns(RuntimeWarning, match="fresh"):
        rvs = RightViewSynthesis(output_shape=SHAPE, model_full_shape=FULL,
                                 model_down_shape=DOWN, device="cpu")
    out = rvs.process(frames(1, 10)[0])
    assert out.shape == (3, *SHAPE) and bool(torch.isfinite(out).all())
    assert float(out.min()) >= 0.0 and float(out.max()) <= 255.0
    again = RightViewSynthesis(output_shape=SHAPE, model_full_shape=FULL,
                               model_down_shape=DOWN, device="cpu")
    for a, b in zip(rvs.model.state_dict().values(),
                    again.model.state_dict().values()):
        assert torch.equal(a, b)                # seed 0 both times
    missing = str(tmp_path / "nowhere")
    with pytest.raises(FileNotFoundError):
        RightViewSynthesis(checkpoint_dir=missing, device="cpu")
    with pytest.raises(FileNotFoundError):
        JaxRightViewSynthesis(checkpoint_dir=missing)


def test_module_cli_on_the_cpu(tmp_path, variables, capsys):
    """``python -m stereo_tpu_torch.synthesis.right_view_synthesis IMAGE``
    (its ``_main``) with ``--device cpu`` and a checkpoint of the small
    model (JAX's variables in an npz with their shapes): writes both views
    at the default output shape."""
    jax_vars, _ = variables
    image = np.random.default_rng(11).integers(0, 256, (*FULL, 3)).astype(
        np.uint8)
    path = tmp_path / "left.png"
    path.write_bytes(encode_png(image))
    ckpt = tmp_path / "small.npz"
    arrays = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf
              in jax.tree_util.tree_flatten_with_path(jax_vars)[0]}
    np.savez(ckpt, **arrays, **{_NPZ_META_PREFIX + "full_shape": list(FULL),
                                _NPZ_META_PREFIX + "down_shape": list(DOWN)})
    rvs_module._main([str(path), "--out-prefix", str(tmp_path / "rvs"),
                      "--checkpoint-dir", str(ckpt), "--device", "cpu"])
    assert "(1280x384)" in capsys.readouterr().out   # the default shape
    assert (png.decode_png((tmp_path / "rvs_left.png").read_bytes())
            == image).all()
    right = png.decode_png((tmp_path / "rvs_right.png").read_bytes())
    assert right.shape == (384, 1280, 3)


def test_launches_recorded_into_a_graph_count_on_replay():
    """A wrapper's launch inside ``capturing_counts`` goes to the graph's
    counts, not to ``LAUNCHES``; ``add_launches`` adds them once per
    replay, so the counts stay the device's runs."""
    from stereo_tpu_torch.ops.cuda import (LAUNCHES, add_launches,
                                           capturing_counts)
    from stereo_tpu_torch.ops.cuda.launch import count_launch

    before = dict(LAUNCHES)
    with capturing_counts() as graph:
        count_launch("matching_core")
        count_launch("sampled_window")
        count_launch("sampled_window[rows_prepadded]")
    assert LAUNCHES == before
    assert graph["matching_core"] == 1 and graph["sampled_window"] == 1
    assert graph["sampled_window[rows_prepadded]"] == 1
    count_launch("upsample_blend")                 # outside: counted
    for _ in range(3):
        add_launches(graph)
    assert LAUNCHES["matching_core"] == before["matching_core"] + 3
    assert LAUNCHES["upsample_blend"] == before["upsample_blend"] + 1
    for name, n in before.items():
        LAUNCHES[name] = n
