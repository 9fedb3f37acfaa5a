"""The port's mesh (``stereo_tpu_torch.parallel``) against ``stereo_tpu``'s:
the row-halo mode of the classical kernels' plain versions, the sharded
classical engine, its pipeline and server wiring, and the health probe.

Both packages run on the CPU with seeded numpy inputs: the JAX engines on
the 8 virtual devices of ``tests/conftest.py`` (its Pallas kernels in
interpret mode), the port on a mesh of ``["cpu"] * n``.  Integer-valued
pairs keep every box sum exact, so the port's sharded engine must equal
its single-device engine bit for bit; against JAX's sharded engine the
contract is JAX's own (1e-4, ``tests/test_parallel.py``).
"""

import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from stereo_tpu.core.config import MatchingConfig as JaxMatchingConfig
from stereo_tpu.core.config import MeshConfig as JaxMeshConfig
from stereo_tpu.ops.pallas import matching_core as jax_matching_core
from stereo_tpu.ops.pallas import sampled_window as jax_sampled_window
from stereo_tpu.parallel import ShardedClassicalEngine as JaxShardedEngine

from stereo_tpu_torch.core.config import (MatchingConfig, MeshConfig,
                                          PipelineConfig)
from stereo_tpu_torch.matching.classical import ClassicalStereoEngine
from stereo_tpu_torch.ops.cuda import (matching_core_plain,
                                       sampled_window_plain)
from stereo_tpu_torch.parallel import (MESH_AXES, ShardedClassicalEngine,
                                       batch_sharding, image_row_sharding,
                                       initialize_distributed, make_mesh,
                                       replicated)
from stereo_tpu_torch.parallel import health
from stereo_tpu_torch.parallel.mesh import Placement
from stereo_tpu_torch.pipeline import DepthEstimationPipeline
from stereo_tpu_torch.pipeline.backends import ShardedClassicalBackend
from stereo_tpu_torch.serve import DepthEstimationServer
from stereo_tpu_torch.serve.api import config_from_args, parse_args
from stereo_tpu_torch.synthesis import RightViewSynthesis
from stereo_tpu_torch.utils.png import decode_png, encode_png

import torch_threads

torch_threads.take_worker_share()

# tests/test_parallel.py's config, and a Middlebury-like one (nonzero
# minimum disparity, larger radii) from tests/test_pallas.py.
CFG = dict(height=32, width=64, downscale_factor=2, min_disparity=0,
           max_disparity=15, cost_patch_radius=1, sad_patch_radius=2,
           threshold=5, small_mbm_radius=1, mid_mbm_radius=1,
           large_mbm_radius=2)
MIDDLEBURY = dict(height=48, width=96, downscale_factor=2, min_disparity=8,
                  max_disparity=23, cost_patch_radius=1, sad_patch_radius=3,
                  threshold=5, small_mbm_radius=1, mid_mbm_radius=2,
                  large_mbm_radius=3)

MESHES = {"single": (1, 1, 1), "dp2": (2, 1, 1), "tile4": (1, 4, 1),
          "disp4": (1, 1, 4), "dp2tile2disp2": (2, 2, 2)}
KERNEL_MESHES = {"single": (1, 1, 1), "tile4": (1, 4, 1),
                 "dp2tile2": (2, 2, 1)}


def cpu_mesh(data, tile, disp):
    mc = MeshConfig(data=data, tile=tile, disp=disp)
    return mc, make_mesh(mc, ["cpu"] * 8)


def integer_batch(cfg, n=2, seed=11, shift=5):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (n, 3, cfg["height"], cfg["width"]))
    left = left.astype(np.float32)
    return left, np.roll(left, -shift, axis=-1).astype(np.float32)


@pytest.fixture(scope="module")
def reference():
    """tests/test_parallel.py's batch and the port's single-device maps."""
    left, right = integer_batch(CFG)
    want = ClassicalStereoEngine(MatchingConfig(**CFG), device="cpu"
                                 ).compute_disparity_maps(left, right)
    return left, right, want


# -- the row-halo mode of the kernels' plain versions -----------------------

# (config, downscaled rows of the shard, downscaled width): the JAX test
# config, and the default radii (KITTI's halo of 11 downscaled rows) on a
# 48-row shard at a narrow width.
HALO_CASES = {
    "test_config": (CFG, 8, 32),
    "kitti_default_radii": (dict(height=384, width=128, min_disparity=0,
                                 max_disparity=64), 48, 64),
}


@pytest.mark.parametrize("name", sorted(HALO_CASES))
def test_row_halo_plain_versions_equal_jax_kernels(name):
    kw, hd, wd = HALO_CASES[name]
    cfg, jcfg = MatchingConfig(**kw), JaxMatchingConfig(**kw)
    k = cfg.k
    pad = cfg.large_mbm_radius + cfg.cost_patch_radius
    sad_r = cfg.sad_patch_radius
    rng = np.random.default_rng(7)
    full = rng.integers(0, 256, (k * hd + 2 * k * (pad + 1), k * wd))
    full = full.astype(np.float32)
    right_full = np.roll(full, -k * 3, axis=-1)
    down = [x.reshape(x.shape[0] // k, k, -1, k).mean(axis=(1, 3))
            for x in (full, right_full)]
    ld, rd = (np.ascontiguousarray(x[1:-1]) for x in down)
    assert ld.shape == (hd + 2 * pad, wd)

    disp, mbm = matching_core_plain(torch.from_numpy(ld),
                                    torch.from_numpy(rd), cfg,
                                    rows_prepadded=True)
    jdisp, jmbm = jax_matching_core(ld, rd, jcfg, rows_prepadded=True)
    assert disp.shape == (hd, wd)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))
    np.testing.assert_array_equal(mbm.numpy(), np.asarray(jmbm))

    rows = slice(k * (pad + 1) - sad_r, k * (pad + 1) + k * hd + sad_r)
    lg, rg = np.ascontiguousarray(full[rows]), np.ascontiguousarray(
        right_full[rows])
    seeded = rng.integers(cfg.min_disparity_down, cfg.max_disparity_down + 1,
                          (hd, wd)).astype(np.float32)
    for winners in (disp.numpy(), seeded):
        got = sampled_window_plain(torch.from_numpy(lg), torch.from_numpy(rg),
                                   torch.from_numpy(winners), cfg,
                                   rows_prepadded=True)
        want = jax_sampled_window(lg, rg, winners, jcfg, rows_prepadded=True)
        assert got.shape == (2 * k + 3, hd, wd)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_row_halo_needs_the_large_radius_largest():
    cfg = MatchingConfig(**dict(CFG, mid_mbm_radius=3))
    x = torch.zeros((8 + 2 * 3, 32))
    with pytest.raises(ValueError, match="large_mbm_radius"):
        matching_core_plain(x, x, cfg, rows_prepadded=True)


# -- the sharded classical engine --------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_engine_matches_single_device_and_jax(mesh, reference):
    left, right, want = reference
    mc, devices = cpu_mesh(*MESHES[mesh])
    engine = ShardedClassicalEngine(MatchingConfig(**CFG), mc, mesh=devices)
    got = engine.compute_disparity_maps(left, right)
    assert got.shape == (2, 32, 64)
    assert torch.equal(got, want)
    jax_got = JaxShardedEngine(JaxMatchingConfig(**CFG),
                               JaxMeshConfig(*MESHES[mesh]))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_got.compute_disparity_maps(left, right)),
        rtol=0, atol=1e-4)


@pytest.mark.parametrize("mesh", sorted(KERNEL_MESHES))
def test_kernel_composition_matches_single_device(mesh, reference):
    """``disp == 1`` with ``impl="auto"`` takes the row-halo kernels (their
    plain versions on the CPU), not the blockwise path."""
    left, right, want = reference
    mc, devices = cpu_mesh(*KERNEL_MESHES[mesh])
    engine = ShardedClassicalEngine(MatchingConfig(**CFG), mc, mesh=devices)
    assert engine.use_kernels
    assert torch.equal(engine.compute_disparity_maps(left, right), want)


@pytest.mark.parametrize("impl,mesh", [("auto", (1, 2, 1)),
                                       ("torch", (1, 2, 1)),
                                       ("auto", (1, 3, 2))])
def test_middlebury_config_and_real_pair(impl, mesh):
    """A nonzero minimum disparity, radii other than the test config's and
    a real-valued pair: both paths equal the single device."""
    cfg = MatchingConfig(**dict(MIDDLEBURY, impl=impl))
    rng = np.random.default_rng(3)
    left = rng.uniform(0, 255, (1, 3, 48, 96)).astype(np.float32)
    right = np.roll(left, -20, axis=-1)
    want = ClassicalStereoEngine(cfg, device="cpu").compute_disparity_maps(
        left, right)
    mc, devices = cpu_mesh(*mesh)
    engine = ShardedClassicalEngine(cfg, mc, mesh=devices)
    assert engine.use_kernels == (impl == "auto" and mesh[2] == 1)
    assert torch.equal(engine.compute_disparity_maps(left, right), want)


def test_impl_cuda_rejects_disp_sharding():
    mc, devices = cpu_mesh(1, 1, 4)
    with pytest.raises(ValueError):
        ShardedClassicalEngine(MatchingConfig(**dict(CFG, impl="cuda")), mc,
                               mesh=devices)


def test_validation():
    cfg = MatchingConfig(**CFG)
    with pytest.raises(ValueError):
        ShardedClassicalEngine(cfg, *cpu_mesh(1, 5, 1))   # 16 % (2*5) != 0
    with pytest.raises(ValueError):
        ShardedClassicalEngine(cfg, *cpu_mesh(1, 1, 3))   # 8 % 3 != 0
    engine = ShardedClassicalEngine(cfg, *cpu_mesh(2, 1, 1))
    with pytest.raises(ValueError, match="batch size"):
        engine.compute_disparity_maps(np.zeros((3, 3, 32, 64)),
                                      np.zeros((3, 3, 32, 64)))


# -- the mesh and its placements ---------------------------------------------

def test_make_mesh():
    mesh = make_mesh(MeshConfig(data=2, tile=2, disp=2), ["cpu"] * 8)
    assert mesh.shape == (2, 2, 2)
    assert mesh.axis_names == MESH_AXES == ("data", "tile", "disp")
    assert mesh.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(RuntimeError, match="wants 16 devices"):
        make_mesh(MeshConfig(data=16), ["cpu"] * 8)
    # The default is the visible cards, never the CPU.
    with pytest.raises(RuntimeError):
        make_mesh(MeshConfig(data=torch.cuda.device_count() + 1))


def test_placements_split_and_gather():
    mesh = make_mesh(MeshConfig(data=2, tile=2, disp=2), ["cpu"] * 8)
    x = torch.arange(4 * 3 * 8 * 5, dtype=torch.float32).reshape(4, 3, 8, 5)
    parts = batch_sharding(mesh).shard(x)
    assert parts.shape == (2, 2, 2) and parts[1, 0, 1].shape == (2, 3, 8, 5)
    assert torch.equal(parts[1, 1, 0], x[2:])
    assert torch.equal(batch_sharding(mesh).gather(parts), x)
    rows = image_row_sharding(mesh).shard(x[0])
    assert torch.equal(rows[0, 1, 0], x[0, :, 4:])
    assert torch.equal(image_row_sharding(mesh).gather(rows), x[0])
    assert torch.equal(replicated(mesh).shard(x)[1, 1, 1], x)
    both = Placement(mesh, (("data", "disp"), None, "tile", None))
    split = both.shard(x)
    assert torch.equal(split[0, 1, 1], x[1:2, :, 4:])
    assert torch.equal(both.gather(split), x)


def test_initialize_distributed_without_address_is_a_no_op():
    initialize_distributed()
    assert not torch.distributed.is_initialized()


# -- pipeline and server -----------------------------------------------------

def test_pipeline_uses_sharded_backend(reference):
    left, right, want = reference
    cfg = PipelineConfig(image_shape=(32, 64), min_disparity=0,
                         max_disparity=15, matching=MatchingConfig(**CFG),
                         stereo_matching_backend="classical",
                         mesh=MeshConfig(data=1, tile=2, disp=2))
    pipeline = DepthEstimationPipeline(cfg, device="cpu")
    assert isinstance(pipeline.stereo_matching, ShardedClassicalBackend)
    assert pipeline.mesh.shape == (1, 2, 2)
    result = pipeline.process(left[0], right[0])
    assert torch.equal(result.disparity_map, want[0])


def test_pipeline_mesh_needs_its_devices():
    cfg = PipelineConfig(image_shape=(32, 64), max_disparity=15,
                         matching=MatchingConfig(**CFG),
                         mesh=MeshConfig(data=1, tile=4, disp=1))
    with pytest.raises(RuntimeError, match="wants 4 devices"):
        DepthEstimationPipeline(cfg, device="cpu", mesh_devices=["cpu"] * 2)


def test_server_mesh_flag():
    config = config_from_args(parse_args(["--mesh", "1,2,1"]))
    assert config.mesh == MeshConfig(data=1, tile=2, disp=1)
    assert config_from_args(parse_args([])).mesh is None


def test_mesh_server_answers_on_cpu():
    """A classical mesh pipeline (2,1,1) behind the micro-batching server:
    concurrent uploads come back as the sharded single view's maps."""
    shape = (48, 96)
    synthesis = RightViewSynthesis(output_shape=shape, seed=0,
                                   model_full_shape=(128, 256),
                                   model_down_shape=(32, 64), device="cpu")
    config = PipelineConfig(image_shape=shape, max_disparity=16,
                            mesh=MeshConfig(data=2))
    with pytest.raises(ValueError, match="batch group"):
        DepthEstimationServer(config, micro_batch=3, device="cpu")
    pipeline = DepthEstimationPipeline(config, synthesis=synthesis,
                                       device="cpu")
    server = DepthEstimationServer(config, pipeline=pipeline, micro_batch=2,
                                   device="cpu")
    images = np.random.default_rng(5).integers(0, 256, (2, *shape, 3),
                                               np.uint8)
    replies = [None, None]

    def post(i):
        req = urllib.request.Request(f"http://{host}:{port}/",
                                     data=encode_png(images[i]),
                                     headers={"Content-Type": "image/png"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            replies[i] = (resp.status, decode_png(resp.read())[..., 0])

    host, port = server.start("127.0.0.1", 0)
    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        server.shutdown()
    assert [r[0] for r in replies] == [200, 200]
    want = pipeline.process_batch(torch.from_numpy(
        images.transpose(0, 3, 1, 2).astype(np.float32))).disparity_map
    for (_, got), w in zip(replies, want):
        np.testing.assert_array_equal(
            got, np.clip(np.round(w.numpy()), 0, 255).astype(np.uint8))


# -- health -------------------------------------------------------------------

def test_check_devices_healthy():
    report = health.check_devices(timeout_s=60, devices=["cpu"] * 8)
    assert report.healthy and report.num_devices == 8


def test_check_devices_reports_a_hang_within_its_deadline(monkeypatch):
    release = threading.Event()
    monkeypatch.setattr(health, "_probe", lambda devices: release.wait(30))
    start = time.perf_counter()
    try:
        report = health.check_devices(timeout_s=0.2, devices=["cpu"])
    finally:
        release.set()
    assert time.perf_counter() - start < 5
    assert not report.healthy and "timed out" in report.detail


def test_check_devices_reports_an_exception(monkeypatch):
    def broken(devices):
        raise RuntimeError("card fell over")

    monkeypatch.setattr(health, "_probe", broken)
    report = health.check_devices(timeout_s=10, devices=["cpu"])
    assert not report.healthy and "card fell over" in report.detail


def test_supervised_runner_retries_then_succeeds():
    calls = {"n": 0, "recovered": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("chip fell over")
        return "ok"

    runner = health.SupervisedRunner(
        recover=lambda: calls.__setitem__("recovered", calls["recovered"] + 1),
        max_retries=3, backoff_s=0.01)
    assert runner.run(flaky) == "ok"
    assert calls["recovered"] == 2 and runner.failures == 2


def test_supervised_runner_gives_up():
    def dead():
        raise RuntimeError("no chips")

    runner = health.SupervisedRunner(max_retries=1, backoff_s=0.0)
    with pytest.raises(RuntimeError):
        runner.run(dead)
