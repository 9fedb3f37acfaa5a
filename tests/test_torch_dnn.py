"""The port's DNN matching backends (GwcNet, MSNet2D, MSNet3D) against
``stereo_tpu``, on the same numpy-seeded inputs and the same weights.

Layers get random numpy weights handed to both packages (as a Flax
variables tree and through ``stereo_state_dict_from_flax``); the networks
run on the committed checkpoints (``data/checkpoints/*.npz``), loaded by
the port with ``strict=True``.  Every JAX model compile here is at a small
image, 64x256 or less.
"""

import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu.models import build_stereo_model as jax_build_stereo_model
from stereo_tpu.models import gwcnet as jgwc
from stereo_tpu.models import layers as jl
from stereo_tpu.models import load_params_npz
from stereo_tpu.pipeline import metrics as jmetrics
from stereo_tpu.pipeline.backends import (
    DnnStereoMatchingBackend as JaxDnnBackend)

from stereo_tpu_torch.core.config import PipelineConfig
from stereo_tpu_torch.models import (build_stereo_model, gwcnet,
                                     load_or_init_params,
                                     stereo_state_dict_from_flax)
from stereo_tpu_torch.models import layers as tl
from stereo_tpu_torch.pipeline import (AVAILABLE_DNN_BACKENDS,
                                       DepthEstimationPipeline,
                                       DnnStereoMatchingBackend)
from stereo_tpu_torch.pipeline import metrics
from stereo_tpu_torch.serve import DepthEstimationServer
from stereo_tpu_torch.serve.api import config_from_args, parse_args
from stereo_tpu_torch.synthesis import RightViewSynthesis
from stereo_tpu_torch.utils import paths
from stereo_tpu_torch.utils.paths import model_checkpoint_dir
from stereo_tpu_torch.utils.png import decode_png, encode_png


def numpy_variables(module, x, seed):
    """Flax variables of ``module`` for input ``x`` with every leaf drawn
    from numpy: kernels normal / sqrt(fan_in), biases and means small,
    BatchNorm scales and variances in 0.5..1.5.  Returns (Flax tree,
    flat arrays keyed as in the npz checkpoints)."""
    rng = np.random.default_rng(seed)
    flat = {}

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = rng.standard_normal(leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        elif name in ("bias", "mean"):
            v = 0.1 * rng.standard_normal(leaf.shape)
        else:
            v = rng.uniform(0.5, 1.5, leaf.shape)
        flat[jax.tree_util.keystr(path)] = v.astype(np.float32)
        return jnp.asarray(v, jnp.float32)

    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
    return jax.tree_util.tree_map_with_path(draw, variables), flat


def channels_first(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


# name: (Flax module, port module, NHWC / NDHWC input shape)
BLOCKS = {
    "convbnact_2d_stride2": (lambda: jl.ConvBnAct(8, (3, 3), 2),
                             lambda: tl.ConvBnAct(4, 8, (3, 3), 2),
                             (2, 8, 10, 4)),
    "convbnact_2d_dilation2": (lambda: jl.ConvBnAct(8, (3, 3), 1, 2),
                               lambda: tl.ConvBnAct(4, 8, (3, 3), 1, 2),
                               (1, 9, 11, 4)),
    "convbnact_1x1_no_act": (lambda: jl.ConvBnAct(6, (1, 1), act=False),
                             lambda: tl.ConvBnAct(4, 6, (1, 1), act=False),
                             (1, 5, 6, 4)),
    "convbnact_3d_stride2": (lambda: jl.ConvBnAct(8, (3, 3, 3), 2),
                             lambda: tl.ConvBnAct(4, 8, (3, 3, 3), 2),
                             (1, 6, 8, 10, 4)),
    "convbnact_3d": (lambda: jl.ConvBnAct(8, (3, 3, 3)),
                     lambda: tl.ConvBnAct(4, 8, (3, 3, 3)), (1, 4, 6, 8, 4)),
    "resblock_projected_stride2": (lambda: jl.BasicResBlock(8, 2),
                                   lambda: tl.BasicResBlock(4, 8, 2),
                                   (1, 8, 10, 4)),
    "resblock_identity": (lambda: jl.BasicResBlock(4),
                          lambda: tl.BasicResBlock(4, 4), (1, 6, 7, 4)),
    "resblock_dilation2": (lambda: jl.BasicResBlock(8, 1, 2),
                           lambda: tl.BasicResBlock(8, 8, 1, 2),
                           (1, 7, 9, 8)),
    "separable_stride2": (lambda: jl.SeparableConvBn2D(6, 2),
                          lambda: tl.SeparableConvBn2D(4, 6, 2),
                          (1, 8, 10, 4)),
    "separable_no_act": (lambda: jl.SeparableConvBn2D(6, act=False),
                         lambda: tl.SeparableConvBn2D(4, 6, act=False),
                         (1, 5, 7, 4)),
    "mobilev2_2d_residual": (lambda: jl.MobileV2Block2D(4),
                             lambda: tl.MobileV2Block2D(4, 4), (1, 6, 8, 4)),
    "mobilev2_2d_stride2": (lambda: jl.MobileV2Block2D(8, 2),
                            lambda: tl.MobileV2Block2D(4, 8, 2),
                            (1, 8, 10, 4)),
    "mobilev2_2d_dilation2": (lambda: jl.MobileV2Block2D(4, dilation=2),
                              lambda: tl.MobileV2Block2D(4, 4, dilation=2),
                              (1, 7, 9, 4)),
    "mobilev2_3d_residual": (lambda: jl.MobileV2Block3D(4),
                             lambda: tl.MobileV2Block3D(4, 4),
                             (1, 4, 6, 8, 4)),
    "mobilev2_3d_stride2": (lambda: jl.MobileV2Block3D(8, 2),
                            lambda: tl.MobileV2Block3D(4, 8, 2),
                            (1, 4, 6, 8, 4)),
    "deconvbn_2d": (lambda: jl.DeconvBn(3, (4, 4), (2, 2)),
                    lambda: tl.DeconvBn(6, 3, rank=2), (1, 4, 5, 6)),
    "deconvbn_3d": (lambda: jl.DeconvBn(3, (4, 4, 4), (2, 2, 2)),
                    lambda: tl.DeconvBn(6, 3, rank=3), (1, 3, 4, 5, 6)),
    # Conv3dMXU's counterpart, the plain Conv, at one output channel.
    "classifier3d": (lambda: jgwc.Classifier3D(4),
                     lambda: gwcnet.Classifier3D(4), (1, 4, 6, 8, 4)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_flax(name):
    make_flax, make_port, shape = BLOCKS[name]
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    module = make_flax()
    variables, flat = numpy_variables(module, x, seed=2)
    want = np.asarray(module.apply(variables, jnp.asarray(x)))
    block = make_port()
    block.load_state_dict(stereo_state_dict_from_flax(flat), strict=True)
    with torch.no_grad():   # eval mode: Flax's use_running_average=True
        got = block.eval()(channels_first(x))
    got = np.moveaxis(got.numpy(), 1, -1)
    assert got.shape == want.shape
    # Float32 sums of up to a few hundred terms in another order.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def textured_pair(h, w, shift, seed=0):
    """A smooth seeded 0..255 scene and its copy shifted ``shift`` columns
    to the left (a fronto-parallel plane at disparity ``shift``)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (3, h // 4, w // 4))
    up = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)
    left = np.clip(np.round(up + rng.uniform(-20, 20, up.shape)), 0, 255)
    left = left.astype(np.float32)
    return left, np.roll(left, -shift, axis=-1)


@pytest.mark.parametrize("name", ["gwcnet", "msnet2d", "msnet3d"])
def test_network_on_committed_checkpoint(name):
    left, right = textured_pair(64, 256, 5)
    mean = np.array([0.485, 0.456, 0.406], np.float32)[:, None, None]
    std = np.array([0.229, 0.224, 0.225], np.float32)[:, None, None]
    lr = [((x / 255.0 - mean) / std)[None] for x in (left, right)]
    npz = model_checkpoint_dir(name) + ".npz"
    jax_model = jax_build_stereo_model(name, max_disparity=64)
    want = np.asarray(jax.jit(lambda v, a, b: jax_model.apply(
        v, a, b, train=False))(load_params_npz(npz), *lr))
    model = build_stereo_model(name, max_disparity=64)
    assert load_or_init_params(model, name) == npz
    with torch.no_grad():
        got = model.eval()(*(torch.from_numpy(x) for x in lr)).numpy()
    assert got.shape == want.shape == (1, 64, 256)
    # Same weights, float32 rounding only.  Seen 6.1e-5 px.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_msnet2d_checkpoint_at_another_disparity_raises():
    with pytest.raises(ValueError, match="max_disparity it was trained with"):
        load_or_init_params(build_stereo_model("msnet2d", 192), "msnet2d")


def test_seeded_init_without_a_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setattr(paths, "MODEL_CHECKPOINT_ROOT", str(tmp_path))
    models = [build_stereo_model("msnet3d", 64) for _ in range(3)]
    for model, seed in zip(models, (3, 3, 4)):
        assert load_or_init_params(model, "msnet3d", seed=seed) == "seeded"
    a, b, c = (m.state_dict() for m in models)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["classif2.weight"], c["classif2.weight"])


@pytest.mark.parametrize("dtype,shape", [("float32", (64, 256)),
                                         ("bfloat16", (32, 128))])
def test_backend_matches_jax(dtype, shape):
    left, right = textured_pair(*shape, 5)
    d = max(32, shape[1] // 4)
    want = np.asarray(JaxDnnBackend("gwcnet", shape, max_disparity=d,
                                    compute_dtype=dtype).process(left, right))
    backend = DnnStereoMatchingBackend("gwcnet", shape, max_disparity=d,
                                       compute_dtype=dtype, device="cpu")
    assert backend.weights.endswith("gwcnet.npz")
    got = backend.process(left, right)
    assert got.dtype == torch.float32 and got.shape == shape
    diff = np.abs(got.numpy() - want)
    if dtype == "float32":
        assert diff.max() <= 1e-3       # seen 3.8e-6 px
    else:
        # bf16 rounds at other points in the two frameworks.  Seen
        # 0.099 px max, 0.0043 px mean.
        assert diff.max() <= 0.5 and diff.mean() <= 0.02


def test_dnn_single_view_pipeline_matches_jax():
    """Deep3D (committed, native 384x1280) then GwcNet, at 96x320 with
    disparities 1..16 (model depth 32)."""
    from stereo_tpu.core.config import PipelineConfig as JaxPipelineConfig
    from stereo_tpu.pipeline.depth_pipeline import (
        DepthEstimationPipeline as JaxPipeline)

    shape = (96, 320)
    left, _ = textured_pair(*shape, 0, seed=4)
    jax_pipe = JaxPipeline(JaxPipelineConfig(
        image_shape=shape, max_disparity=16, stereo_matching_backend="gwcnet"))
    want = np.asarray(jax_pipe.process(left).disparity_map)
    pipe = DepthEstimationPipeline(PipelineConfig(
        image_shape=shape, max_disparity=16, stereo_matching_backend="gwcnet"),
        device="cpu")
    result = pipe.process(left)
    assert result.disparity_map.shape == shape
    assert result.right_image.shape == (3, *shape)
    # Deep3D's views differ by float rounding (2.7e-4 grey levels), and
    # GwcNet's soft-argmin carries that through.  Seen 0.0097 px.
    assert np.abs(result.disparity_map.numpy() - want).max() <= 0.05
    assert set(pipe.stage_times()) == {"right_view_generation",
                                       "stereo_matching"}


def test_unknown_dnn_backend_raises():
    with pytest.raises(RuntimeError, match="Unknown DNN backend"):
        DnnStereoMatchingBackend("psmnet", (32, 128), device="cpu")


@pytest.mark.parametrize("metric", ["D1", "Threshold_1", "Threshold_3",
                                    "MAE"])
def test_metrics_match_jax(metric):
    rng = np.random.default_rng(9)
    gt = rng.uniform(0, 64, (24, 40)).astype(np.float32)
    gt[:4] = 0.0                                    # no ground truth there
    est = gt + rng.normal(0, 3, gt.shape).astype(np.float32)
    mask = (gt > 0) & (gt <= 48)
    port = {m.name(): m for m in metrics.default_metrics()}[metric]
    want = {m.name(): m for m in jmetrics.default_metrics()}[metric]
    got = port.process(torch.from_numpy(est), gt, mask)
    assert got == pytest.approx(want.process(est, gt, mask), abs=1e-6)
    assert port.process(est, gt, np.zeros_like(mask)) == 0.0


def test_server_flags():
    args = parse_args(["--backend", "msnet3d", "--compute-dtype", "bfloat16",
                       "--max-disparity", "96"])
    config = config_from_args(args)
    assert config.stereo_matching_backend == "msnet3d"
    assert config.compute_dtype == "bfloat16"
    assert config.max_disparity == 96 and config.image_shape == (384, 1280)
    default = config_from_args(parse_args([]))
    assert (default.stereo_matching_backend, default.compute_dtype) == (
        "classical", "float32")
    with pytest.raises(SystemExit):
        parse_args(["--backend", "psmnet"])


def test_gwcnet_server_answers_on_cpu():
    shape = (48, 96)
    synthesis = RightViewSynthesis(output_shape=shape, seed=0,
                                   model_full_shape=(128, 256),
                                   model_down_shape=(32, 64), device="cpu")
    config = PipelineConfig(image_shape=shape, max_disparity=16,
                            stereo_matching_backend="gwcnet")
    pipeline = DepthEstimationPipeline(config, synthesis=synthesis,
                                       device="cpu")
    server = DepthEstimationServer(config, pipeline=pipeline, device="cpu")
    host, port = server.start("127.0.0.1", 0)
    image = np.random.default_rng(5).integers(0, 256, (*shape, 3), np.uint8)
    try:
        req = urllib.request.Request(f"http://{host}:{port}/",
                                     data=encode_png(image),
                                     headers={"Content-Type": "image/png"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, body = resp.status, resp.read()
        with urllib.request.urlopen(f"http://{host}:{port}/",
                                    timeout=30) as resp:
            info = json.loads(resp.read())
    finally:
        server.shutdown()
    assert status == 200 and info["backend"] == "gwcnet"
    reply = decode_png(body)[..., 0]
    want = pipeline.process(torch.from_numpy(
        image.transpose(2, 0, 1).astype(np.float32))).disparity_map
    np.testing.assert_array_equal(
        reply, np.clip(np.round(want.numpy()), 0, 255).astype(np.uint8))


# D1 with the real right view, JAX package's committed-weight record
# (results/evaluation/evaluation_r05_native_protocol.json).
NATIVE_D1 = {"gwcnet": 0.00038426719038398005,
             "msnet2d": 0.004900614672806114,
             "msnet3d": 0.001183319143819972}


@pytest.mark.slow
def test_d1_at_the_native_protocol():
    """The held-out synthetic rvs-off scenes of the evaluation (seed
    20260817, 8 frames, 384x1280, disparities 0..64, mask 0 < gt <= 64),
    made with the JAX package's camera; the port's three DNN backends on
    the committed weights reproduce the recorded D1 within 0.001."""
    from stereo_tpu.pipeline.camera import SyntheticStereoCamera

    camera = SyntheticStereoCamera(n_frames=8, height=384, width=1280,
                                   return_right_view=True, seed=20260817,
                                   depth_prior=False)
    lo, hi = camera.get_disparity_boundaries()
    frames = [tuple(np.array(a) for a in f)
              for f in camera.stream_image_pairs_with_gt_disparity()]
    d1 = metrics.D1Metric()
    for name, want in NATIVE_D1.items():
        pipe = DepthEstimationPipeline(PipelineConfig(
            image_shape=(384, 1280), min_disparity=lo, max_disparity=hi,
            stereo_matching_backend=name), device="cpu")
        got = np.mean([d1.process(pipe.process(left, right).disparity_map,
                                  gt, (gt > 0) & (gt <= hi))
                       for left, right, gt in frames])
        print(f"{name}: D1 {got:.6f} (recorded {want:.6f})")
        assert abs(got - want) <= 0.001, (name, got, want)


# D1 with Deep3D's right view (rvs on), the same record: the committed
# Deep3D and each backend's committed weights.
RVS_ON_D1 = {"classical": 0.09480642108246684,
             "gwcnet": 0.017927043576491997,
             "msnet2d": 0.02935918339062482,
             "msnet3d": 0.020157878432655707}


@pytest.mark.slow
def test_rvs_on_d1_at_the_native_protocol():
    """The evaluation's rvs-on arms: the held-out depth-prior scenes of the
    port's ``SyntheticStereoCamera`` (seed 20260817, 8 frames, 384x1280,
    disparities 0..64, mask 0 < gt <= 64), the right view synthesized by
    the committed Deep3D (``data/checkpoints/deep3d.npz``, one synthesis
    shared by the arms, as the evaluation script shares it), each of the
    four backends on its committed weights: D1 within 0.001 of the
    record."""
    from stereo_tpu_torch.pipeline.camera import SyntheticStereoCamera
    from stereo_tpu_torch.pipeline.runner import (
        run_depth_estimation_pipeline_evaluation)

    camera = SyntheticStereoCamera(n_frames=8, height=384, width=1280,
                                   return_right_view=False, seed=20260817,
                                   depth_prior=True)
    lo, hi = camera.get_disparity_boundaries()
    assert os.path.isfile(paths.DEEP3D_CHECKPOINT_DIR + ".npz")
    synthesis = RightViewSynthesis(output_shape=(384, 1280), device="cpu")
    for name, want in RVS_ON_D1.items():
        pipe = DepthEstimationPipeline(PipelineConfig(
            image_shape=(384, 1280), min_disparity=lo, max_disparity=hi,
            stereo_matching_backend=name), synthesis=synthesis, device="cpu")
        got = run_depth_estimation_pipeline_evaluation(
            camera, pipe, [metrics.D1Metric()], verbose=False)["D1"]
        print(f"{name}: rvs-on D1 {got:.6f} (recorded {want:.6f})")
        assert abs(got - want) <= 0.001, (name, got, want)


@pytest.mark.slow
def test_networks_agree_with_jax_on_the_noise_pair():
    """The seeded white-noise pair ``chip_smoke.py`` times the networks on
    (uniform integer RGB and its roll by -11 columns, 384x1280): the port
    on the CPU and the JAX package give the same disparity, so the
    medians the card prints for it are the networks' own answers."""
    rng = np.random.default_rng(0)
    left = np.round(rng.uniform(0, 255, (3, 384, 1280))).astype(np.float32)
    right = np.roll(left, -11, axis=-1)
    for name in AVAILABLE_DNN_BACKENDS:
        want = np.asarray(JaxDnnBackend(name, (384, 1280), max_disparity=64)
                          .process(left, right))
        got = DnnStereoMatchingBackend(
            name, (384, 1280), max_disparity=64, device="cpu").process(
                torch.from_numpy(left), torch.from_numpy(right)).numpy()
        diff = float(np.abs(got - want).max())
        print(f"{name}: median {np.median(got[:, 64:-64]):.6f} "
              f"(JAX {np.median(want[:, 64:-64]):.6f}), max |diff| {diff:.3g}")
        assert diff <= 1e-3, (name, diff)
