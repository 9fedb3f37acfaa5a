"""The port's sharded DNN and single-view engines against ``stereo_tpu``'s,
on the CPU: the JAX engines on the 8 virtual devices of
``tests/conftest.py``, the port on a mesh of ``["cpu"] * 8``.

JAX splits each network's convolutions by rows over ``tile`` (GSPMD); so
does the port, with a halo exchange per layer, when 16 * tile divides the
height (``stereo_tpu_torch/parallel/dnn.py``, ``ops/rows.py``; the
split's own tests are in ``tests/test_torch_row_split.py``), and it deals
whole frames over the ``tile`` devices otherwise.  At 64x96 on (2,2,2) the
split equals the single device bit for bit on the CPU.  The single view
splits Deep3D's rows the same way (``parallel/synthesis.py``; its tests in
``tests/test_torch_row_split_deep3d.py``): on (2,2,2) it is held to the
single device at float rounding and JAX's gate, and the frames dealt on
(1,8,1) (which splits rows too unless told to deal) bit for bit.  The
gates against JAX are the JAX tests' own (``tests/test_parallel_dnn.py``,
``tests/test_parallel_synthesis.py``).
"""

import jax
import numpy as np
import pytest
import torch

from stereo_tpu.core.config import MatchingConfig as JaxMatchingConfig
from stereo_tpu.core.config import MeshConfig as JaxMeshConfig
from stereo_tpu.models import Deep3D as JaxDeep3D
from stereo_tpu.models import load_params_npz
from stereo_tpu.parallel import ShardedDnnEngine as JaxShardedDnnEngine
from stereo_tpu.parallel import (
    ShardedSingleViewEngine as JaxShardedSingleViewEngine)
from stereo_tpu.synthesis import RightViewSynthesis as JaxRightViewSynthesis

from stereo_tpu_torch.core.config import (MatchingConfig, MeshConfig,
                                          PipelineConfig)
from stereo_tpu_torch.matching.classical import ClassicalStereoEngine
from stereo_tpu_torch.models import deep3d_state_dict_from_flax
from stereo_tpu_torch.parallel import (ShardedDnnEngine,
                                       ShardedSingleViewEngine, make_mesh)
from stereo_tpu_torch.parallel.dnn import frame_devices
from stereo_tpu_torch.pipeline import (DepthEstimationPipeline,
                                       DnnStereoMatchingBackend)
from stereo_tpu_torch.pipeline.backends import ShardedDnnBackend
from stereo_tpu_torch.synthesis import RightViewSynthesis
from stereo_tpu_torch.utils.paths import model_checkpoint_dir

import torch_threads

torch_threads.take_worker_share()

H, W, D = 64, 96, 16
MESH = (2, 2, 2)


def cpu_mesh(data, tile, disp):
    mc = MeshConfig(data=data, tile=tile, disp=disp)
    return mc, make_mesh(mc, ["cpu"] * 8)


def _inputs(batch, h, w, seed=0):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (batch, 3, h, w)).astype(np.float32)
    return left, np.roll(left, -3, axis=-1).copy()


@pytest.fixture(scope="module")
def gwcnet():
    """The port's sharded engine and single-device backend on the committed
    GwcNet checkpoint, converted as the port loads it."""
    mc, mesh = cpu_mesh(*MESH)
    engine = ShardedDnnEngine("gwcnet", (H, W), mc, mesh=mesh,
                              max_disparity=D)
    single = DnnStereoMatchingBackend("gwcnet", (H, W), max_disparity=D,
                                      device="cpu")
    assert engine.weights == single.weights == (
        model_checkpoint_dir("gwcnet") + ".npz")
    return engine, single


def test_frame_placement():
    _, mesh = cpu_mesh(*MESH)
    mesh.devices[:] = np.arange(8).reshape(2, 2, 2)   # label the slots
    # 8 frames: groups (d, p) of 2 frames, each dealt over the 2 tiles.
    assert frame_devices(mesh, 8) == [0, 2, 1, 3, 4, 6, 5, 7]
    assert frame_devices(mesh, 4) == [0, 1, 4, 5]


def test_gwcnet_sharded_matches_jax_and_single_device(gwcnet):
    engine, single = gwcnet
    left, right = _inputs(4, H, W)
    out = engine.process_batch(left, right)
    assert out.shape == (4, H, W)
    for i in range(4):
        assert torch.equal(out[i], single.process(left[i], right[i]))
    jax_engine = JaxShardedDnnEngine(
        "gwcnet", (H, W), JaxMeshConfig(*MESH), max_disparity=D,
        params=load_params_npz(model_checkpoint_dir("gwcnet") + ".npz"))
    want = np.asarray(jax_engine.process_batch(left, right))
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=5e-3)


def test_batch_group_and_height_validation(gwcnet):
    engine, _ = gwcnet
    assert engine.batch_group == 4
    left, right = _inputs(3, H, W)
    with pytest.raises(ValueError, match="not divisible"):
        engine.process_batch(left, right)
    mc, mesh = cpu_mesh(*MESH)
    with pytest.raises(ValueError, match="height"):
        ShardedDnnEngine("gwcnet", (65, W), mc, mesh=mesh, max_disparity=D)


def test_single_frame_process_is_frame_zero(gwcnet):
    engine, single = gwcnet
    backend = ShardedDnnBackend.__new__(ShardedDnnBackend)
    backend.engine = engine
    left, right = _inputs(1, H, W, seed=3)
    out = backend.process(left[0], right[0])
    assert out.shape == (H, W)
    assert torch.equal(out, single.process(left[0], right[0]))


def test_pipeline_selects_sharded_dnn_backend():
    cfg = PipelineConfig(image_shape=(H, W), min_disparity=0,
                         max_disparity=32, stereo_matching_backend="gwcnet",
                         mesh=MeshConfig(data=2, tile=2, disp=2))
    pipe = DepthEstimationPipeline(cfg, device="cpu")
    assert isinstance(pipe.stereo_matching, ShardedDnnBackend)
    assert len(pipe.stereo_matching.engine.replicas) == 1   # one CPU copy


# -- the sharded single view -------------------------------------------------

def _matching(h=64, w=96):
    return dict(height=h, width=w, downscale_factor=2, min_disparity=0,
                max_disparity=15, cost_patch_radius=1, sad_patch_radius=2,
                threshold=5, small_mbm_radius=1, mid_mbm_radius=1,
                large_mbm_radius=2)


@pytest.fixture(scope="module")
def small_deep3d():
    """A small Deep3D from ``Deep3D().init(PRNGKey(0), ...)`` (as
    tests/test_parallel_synthesis.py) carried to the port by the
    converter, with the port's synthesis on it."""
    full = np.zeros((1, 3, 128, 256), np.float32)
    down = np.zeros((1, 3, 32, 64), np.float32)
    variables = JaxDeep3D().init(jax.random.PRNGKey(0), full, down,
                                 train=False)
    arrays = {jax.tree_util.keystr(path): np.array(leaf, np.float32)
              for path, leaf in jax.tree_util.tree_leaves_with_path(
                  variables)}
    synthesis = RightViewSynthesis(
        output_shape=(64, 96), state_dict=deep3d_state_dict_from_flax(arrays),
        model_full_shape=(128, 256), model_down_shape=(32, 64), device="cpu")
    return variables, synthesis


def test_single_view_matches_jax_and_single_device(small_deep3d):
    variables, synthesis = small_deep3d
    left = np.random.default_rng(0).integers(0, 256, (4, 3, 64, 96)).astype(
        np.float32)
    mc, mesh = cpu_mesh(*MESH)
    engine = ShardedSingleViewEngine(MatchingConfig(**_matching()), mc,
                                     mesh=mesh, synthesis=synthesis)
    # (2,2,2) splits Deep3D's rows over the tile pair (16 of the 32 down
    # rows a shard: parallel/synthesis.py).
    assert engine.row_split
    out, right = engine.process_batch(left, return_right=True)
    assert out.shape == (4, 64, 96) and right.shape == (4, 3, 64, 96)
    assert torch.equal(engine.process_batch(left), out)

    # The single-device path frame by frame (Deep3D at batch 1, as each
    # group's one frame on the mesh): the split views within float rounding
    # of their convolutions, the disparities at JAX's gate.
    matcher = ClassicalStereoEngine(MatchingConfig(**_matching()),
                                    device="cpu")
    singles = [synthesis.process(torch.from_numpy(left[i])) for i in range(4)]
    torch.testing.assert_close(right, torch.stack(singles), rtol=0,
                               atol=1e-3)
    diff = np.abs(out.numpy() - torch.stack(
        [matcher.compute_disparity_map(left[i], singles[i])
         for i in range(4)]).numpy())
    assert np.mean(diff <= 0.5) >= 0.99 and diff.mean() < 0.1

    # Whole frames dealt over the tile devices are equal bit for bit.
    # (1,8,1) splits the 32 down rows (4 a shard) unless told to deal.
    mc8, mesh8 = cpu_mesh(1, 8, 1)
    dealt = ShardedSingleViewEngine(MatchingConfig(**_matching()), mc8,
                                    mesh=mesh8, synthesis=synthesis)
    assert dealt.row_split
    dealt.row_split = False
    dealt_out, dealt_right = dealt.process_batch(left, return_right=True)
    for i in range(4):
        assert torch.equal(dealt_right[i], singles[i])
        assert torch.equal(dealt_out[i],
                           matcher.compute_disparity_map(left[i], singles[i]))

    # At batch 4 the CPU convolutions round in other places (the views
    # differ in their last bits), so the single-device batch and the JAX
    # engine are held to JAX's gate: near-tie WTA flips only.
    batch = DepthEstimationPipeline(
        PipelineConfig(image_shape=(64, 96), min_disparity=1,
                       max_disparity=15, matching=MatchingConfig(
                           **_matching())),
        synthesis=synthesis, device="cpu").process_batch(left)
    jax_engine = JaxShardedSingleViewEngine(
        JaxMatchingConfig(**_matching()), JaxMeshConfig(*MESH),
        synthesis=JaxRightViewSynthesis(output_shape=(64, 96),
                                        variables=variables,
                                        model_full_shape=(128, 256),
                                        model_down_shape=(32, 64)))
    for ref in (batch.disparity_map.numpy(),
                np.asarray(jax_engine.process_batch(left))):
        diff = np.abs(out.numpy() - ref)
        assert np.mean(diff <= 0.5) >= 0.99 and diff.mean() < 0.1


def test_pipeline_dispatch_under_mesh(small_deep3d):
    """``process_batch(left, None)`` under a multi-device mesh routes
    through the sharded single view and returns the result triple."""
    _, synthesis = small_deep3d
    pcfg = PipelineConfig(image_shape=(64, 96), min_disparity=1,
                          max_disparity=15,
                          matching=MatchingConfig(**_matching()),
                          mesh=MeshConfig(data=2, tile=2, disp=2))
    pipeline = DepthEstimationPipeline(pcfg, synthesis=synthesis,
                                       device="cpu")
    left = np.random.default_rng(1).integers(
        0, 256, (4, 3, 64, 96)).astype(np.float32)
    result = pipeline.process_batch(left)
    assert result.disparity_map.shape == (4, 64, 96)
    assert result.right_image.shape == left.shape
    assert result.left_image.shape == left.shape
    assert pipeline._sharded_sv_engine is not None


def test_single_view_batch_and_height_validation(small_deep3d):
    _, synthesis = small_deep3d
    mc, mesh = cpu_mesh(*MESH)
    engine = ShardedSingleViewEngine(MatchingConfig(**_matching()), mc,
                                     mesh=mesh, synthesis=synthesis)
    assert engine.batch_group == 4
    with pytest.raises(ValueError, match="not divisible"):
        engine.process_batch(np.zeros((3, 3, 64, 96), np.float32))
    mc, mesh = cpu_mesh(1, 4, 2)
    with pytest.raises(ValueError, match="height"):
        ShardedSingleViewEngine(MatchingConfig(**_matching(h=66)), mc,
                                mesh=mesh, synthesis=synthesis)
