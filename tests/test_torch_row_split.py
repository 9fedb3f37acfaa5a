"""The row split inside the stereo networks (``stereo_tpu_torch/ops/
rows.py``, its threads in ``parallel/rows.py``) on the CPU: each halo
funnel split by rows against the whole frame, the three networks split by
rows against the single device, GwcNet on (1,4,1), (1,8,1) at 48 and 64
rows and shards of four rows against JAX's ``ShardedDnnEngine`` (GSPMD on
the 8 virtual devices of ``tests/conftest.py``), the three networks at
heights whose shards gather ahead of a stride, whole frames
dealt through ``row_split = False``, a split forward under grad freed
without its backward, and a failing shard.  Gates: 1e-5 for a funnel,
1e-4 px for a network against the single device, JAX's own 5e-3 px
against JAX (``tests/test_parallel_dnn.py``)."""

import gc
import threading

import numpy as np
import pytest
import torch

from stereo_tpu.core.config import MeshConfig as JaxMeshConfig
from stereo_tpu.models import load_params_npz
from stereo_tpu.parallel import ShardedDnnEngine as JaxShardedDnnEngine

from stereo_tpu_torch.core.config import MeshConfig, PipelineConfig
from stereo_tpu_torch.models.cost_volumes import upsampled_soft_argmin
from stereo_tpu_torch.models.layers import (deconv2d_parity,
                                            pack_parity_weight,
                                            upsample_trilinear)
from stereo_tpu_torch.ops.conv3d import (conv_same, deconv3d_parity,
                                         pack_deconv3d_weight)
from stereo_tpu_torch.ops import rows
from stereo_tpu_torch.parallel import ShardedDnnEngine, make_mesh
from stereo_tpu_torch.parallel.rows import ShardThreads
from stereo_tpu_torch.pipeline import (DepthEstimationPipeline,
                                       DnnStereoMatchingBackend)
from stereo_tpu_torch.utils.paths import model_checkpoint_dir

import torch_threads

torch_threads.take_worker_share()

H, W = 64, 96


def _split(fn, x, tile, *args):
    """``fn(shard, *args)`` on ``tile`` row shards of ``x`` (rows axis -2)
    in a row split on the CPU, joined along the rows."""
    per = x.shape[-2] // tile
    results, _ = _run([[("cpu", lambda t=t: fn(
        x.narrow(-2, t * per, per), *args)) for t in range(tile)]])
    return torch.cat(results[0], dim=-2)


def _run(splits):
    threads = ShardThreads()
    try:
        return threads.run(splits)
    finally:
        threads.close()


def _randn(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


# Each funnel of the networks' row-mixing layers: (name, input, function).
FUNNELS = {
    "conv2d_stride1": ((1, 4, 16, 12), lambda x, w: conv_same(x, w),
                       (5, 4, 3, 3)),
    "conv2d_stride2": ((1, 4, 16, 12), lambda x, w: conv_same(x, w, stride=2),
                       (5, 4, 3, 3)),
    "conv2d_dilation2": ((1, 4, 16, 12),
                         lambda x, w: conv_same(x, w, dilation=2),
                         (5, 4, 3, 3)),
    "conv2d_1x1_stride2": ((1, 4, 16, 12),
                           lambda x, w: conv_same(x, w, stride=2),
                           (5, 4, 1, 1)),
    "conv3d_stride2": ((1, 3, 4, 16, 12),
                       lambda x, w: conv_same(x, w, stride=2), (4, 3, 3, 3, 3)),
    "deconv2d_parity": ((1, 4, 8, 6), lambda x, w: deconv2d_parity(
        x, pack_parity_weight(w, 2), 2), (4, 4, 4, 3)),
    "deconv3d_parity": ((1, 3, 4, 8, 6), lambda x, w: deconv3d_parity(
        x, pack_deconv3d_weight(w)), (4, 4, 4, 3, 2)),
    "bilinear": ((2, 5, 8, 6), lambda x, w: rows.interpolate(
        x, (x.shape[-2] * 4, 24), "bilinear"), None),
    "trilinear": ((1, 1, 4, 8, 6), lambda x, w: upsample_trilinear(
        x, (16, x.shape[-2] * 4, 24)), None),
    "soft_argmin": ((1, 1, 4, 8, 6), lambda x, w: upsampled_soft_argmin(
        x, (16, x.shape[-2] * 4, 24)), None),
}


@pytest.mark.parametrize("tile", [1, 2, 4])
@pytest.mark.parametrize("funnel", sorted(FUNNELS))
def test_funnel_split_matches_whole(funnel, tile):
    shape, fn, wshape = FUNNELS[funnel]
    x = _randn(*shape)
    w = None if wshape is None else _randn(*wshape, seed=1)
    want = fn(x, w)
    got = _split(fn, x, tile, w)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_halo_rows_and_edges():
    """Each shard's halo holds its neighbours' edge rows, and zeros or its
    own edge row repeated at the frame's top and bottom."""
    x = torch.arange(8 * 3, dtype=torch.float32).view(1, 1, 8, 3)
    parts = _split(lambda s: rows.halo(s, 1, 2), x, 4).split(5, dim=-2)
    assert torch.equal(parts[0][..., 0, :], torch.zeros(1, 1, 3))
    assert torch.equal(parts[1][..., 0, :], x[..., 1, :])
    assert torch.equal(parts[1][..., 3:, :], x[..., 4:6, :])
    assert torch.equal(parts[3][..., 3:, :], torch.zeros(1, 1, 2, 3))
    repl = _split(lambda s: rows.halo(s, 1, 1, edge="replicate"), x, 2)
    top, bottom = repl.split(6, dim=-2)
    assert torch.equal(top[..., 0, :], x[..., 0, :])
    assert torch.equal(top[..., 5, :], x[..., 4, :])
    assert torch.equal(bottom[..., 0, :], x[..., 3, :])
    assert torch.equal(bottom[..., 5, :], x[..., 7, :])


@pytest.fixture(scope="module")
def singles():
    """The single-device backends on the committed checkpoints (MSNet2D's
    parameters are made at disparity 64)."""
    return {name: DnnStereoMatchingBackend(name, (H, W), max_disparity=d,
                                           device="cpu")
            for name, d in (("gwcnet", 16), ("msnet2d", 64),
                            ("msnet3d", 16))}


def _inputs(batch, h=H, seed=0):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (batch, 3, h, W)).astype(np.float32)
    return left, np.roll(left, -3, axis=-1).copy()


def _engine(single, tile, data=1, h=H):
    mc = MeshConfig(data=data, tile=tile, disp=1)
    engine = ShardedDnnEngine(single.model_name, (h, W), mc,
                              mesh=make_mesh(mc, ["cpu"] * mc.num_devices),
                              max_disparity=single.model.max_disparity)
    assert engine.weights == single.weights == (
        model_checkpoint_dir(single.model_name) + ".npz")
    return engine


@pytest.mark.parametrize("tile", [2, 4])
@pytest.mark.parametrize("name", ["gwcnet", "msnet2d", "msnet3d"])
def test_network_split_matches_single_device(singles, name, tile):
    single = singles[name]
    engine = _engine(single, tile, data=2)
    assert engine.row_split
    left, right = _inputs(2, seed=tile)
    got = engine.process_batch(left, right)
    want = single.process_batch(left, right)
    assert got.shape == (2, H, W)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    # Every shard exchanged at every row-mixing layer; the bytes are the
    # halo rows each of the 2 x (tile - 1) inner edges passed.  16 divides
    # a shard's rows: no gather.
    assert engine.halo["rounds"] > 0 and engine.halo["bytes"] > 0
    assert engine.halo["gather_rounds"] == 0


# Heights whose shards' rows 16 does not divide: 24 rows (1/8 odd: the
# three hourglasses gather ahead of their second stride), 12 (1/4 odd:
# ahead of their first), 8 (1/8 of one row: ahead of their second), 6
# (1/2 odd: the feature extractors gather ahead of their second stride),
# 4 (1/4 of one row, short of the dilated blocks' halo of two: there too).
OTHER_HEIGHTS = [(48, 2), (48, 4), (64, 8), (48, 8), (16, 4), (32, 8)]
GATHERS = {24: 3, 12: 3, 8: 3, 6: 1, 4: 1}


@pytest.mark.parametrize("h,tile", OTHER_HEIGHTS)
@pytest.mark.parametrize("name", ["gwcnet", "msnet2d", "msnet3d"])
def test_network_split_at_every_height(singles, name, h, tile):
    """At every height JAX splits, the rows split: a shard gathers ahead
    of the stride that would split a row and narrows back where the rows
    divide again, within 1e-4 px of the single device."""
    single = singles[name]
    engine = _engine(single, tile, h=h)
    assert engine.row_split
    left, right = _inputs(1, h=h, seed=tile)
    got = engine.process_batch(left, right)
    want = single.process_batch(left, right)
    assert got.shape == (1, h, W)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert engine.halo["rounds"] > 0 and engine.halo["bytes"] > 0
    assert engine.halo["gather_rounds"] == GATHERS[h // tile]


def test_gwcnet_split_matches_jax(singles):
    single = singles["gwcnet"]
    engine = _engine(single, 4)
    left, right = _inputs(1, seed=5)
    out = engine.process_batch(left, right).numpy()
    jax_engine = JaxShardedDnnEngine(
        "gwcnet", (H, W), JaxMeshConfig(data=1, tile=4, disp=1),
        max_disparity=16,
        params=load_params_npz(model_checkpoint_dir("gwcnet") + ".npz"))
    want = np.asarray(jax_engine.process_batch(left, right))
    np.testing.assert_allclose(out, want, rtol=0, atol=5e-3)


@pytest.mark.parametrize("h", [48, 64])
def test_gwcnet_split_on_tile_8_matches_jax(singles, h):
    """(1,8,1) at 48 rows (the feature extractor gathers) and 64 (the
    hourglasses gather), against JAX's GSPMD engine, which splits both."""
    single = singles["gwcnet"]
    engine = _engine(single, 8, h=h)
    left, right = _inputs(1, h=h, seed=h)
    out = engine.process_batch(left, right).numpy()
    jax_engine = JaxShardedDnnEngine(
        "gwcnet", (h, W), JaxMeshConfig(data=1, tile=8, disp=1),
        max_disparity=16,
        params=load_params_npz(model_checkpoint_dir("gwcnet") + ".npz"))
    want = np.asarray(jax_engine.process_batch(left, right))
    np.testing.assert_allclose(out, want, rtol=0, atol=5e-3)


# Shards of four rows, whose 1/4 level (one row) is short of the dilated
# blocks' halo: (height, tile, the tile of JAX's engine held to).  At 32
# rows on (1,8,1) JAX's GSPMD engine lies pixels off its own unsharded
# engine, which the port is held to there.
FOUR_ROW_SHARDS = [(16, 4, 4), (32, 8, 1)]


@pytest.mark.parametrize("h,tile,jax_tile", FOUR_ROW_SHARDS)
def test_gwcnet_split_of_four_row_shards_matches_jax(singles, h, tile,
                                                     jax_tile):
    """The feature extractor gathers ahead of its second stride, within
    JAX's 5e-3 px of JAX's engine."""
    engine = _engine(singles["gwcnet"], tile, h=h)
    left, right = _inputs(1, h=h, seed=h)
    out = engine.process_batch(left, right).numpy()
    assert engine.halo["gather_rounds"] == 1
    jax_engine = JaxShardedDnnEngine(
        "gwcnet", (h, W), JaxMeshConfig(data=1, tile=jax_tile, disp=1),
        max_disparity=16,
        params=load_params_npz(model_checkpoint_dir("gwcnet") + ".npz"))
    want = np.asarray(jax_engine.process_batch(left, right))
    np.testing.assert_allclose(out, want, rtol=0, atol=5e-3)


def test_row_split_reported_and_frame_fallback(singles):
    """``row_split`` is true exactly when ``tile > 1``, at every height
    JAX accepts, 48 rows on tile 2 included; set False, the engine deals
    whole frames, equal to the single device.  The pipeline's mesh route
    and a single frame take the split."""
    single = singles["gwcnet"]
    assert not _engine(single, 1, data=2).row_split
    assert _engine(single, 4).row_split
    fallback = _engine(single, 2, h=48)           # 48 % 32 != 0
    assert fallback.row_split
    fallback.row_split = False
    left, right = _inputs(2, h=48, seed=7)
    got = fallback.process_batch(left, right)
    assert torch.equal(got, torch.stack([single.process(l, r)
                                         for l, r in zip(left, right)]))
    assert fallback.halo is None

    cfg = PipelineConfig(image_shape=(H, W), min_disparity=0,
                         max_disparity=16, stereo_matching_backend="gwcnet",
                         mesh=MeshConfig(data=1, tile=2, disp=1))
    pipe = DepthEstimationPipeline(cfg, device="cpu")
    engine = pipe.stereo_matching.engine
    assert engine.row_split
    left, right = _inputs(1, seed=8)
    result = pipe.process(left[0], right[0])
    assert engine.halo["rounds"] > 0
    # The pipeline's network is made at disparity 32: its own replica,
    # called outside a split, runs the whole frame.
    whole = engine.replicas[torch.device("cpu")].process(left[0], right[0])
    torch.testing.assert_close(result.disparity_map, whole, rtol=0,
                               atol=1e-4)


def _live_runs() -> int:
    gc.collect()
    return sum(type(o) in (rows.RowExchange, rows.Rounds)
               for o in gc.get_objects())


def test_split_forward_under_grad_without_backward_is_freed():
    """A split forward under grad mode whose outputs are dropped without a
    backward (a loss for evaluation, an error before the backward) leaves
    none of its exchanges behind: each round's autograd node holds what
    its backward reads, and not the run's exchanges, which reach the node
    again through their token."""
    w1, w2 = (_randn(4, 4, 3, 3, seed=s).requires_grad_() for s in (1, 2))
    x = _randn(1, 4, 8, 6)
    before = _live_runs()
    threads = ShardThreads()
    try:
        for _ in range(3):
            with torch.enable_grad():
                results, exchanges = threads.run([[(
                    "cpu", lambda t=t: rows.conv2d(rows.conv2d(
                        x[..., 4 * t:4 * t + 4, :], w1), w2))
                    for t in range(2)]])
            assert results[0][0].requires_grad and exchanges[0].rounds == 2
            del results, exchanges
            assert _live_runs() == before
    finally:
        threads.close()


def test_failing_shard_raises_without_hanging():
    """A shard that raises aborts the exchange its neighbours wait at; the
    error surfaces in the caller, within seconds."""
    def work(t):
        x = torch.ones(1, 1, 4, 3)
        if t == 1:
            raise ValueError("shard 1 failed")
        for _ in range(3):
            x = rows.halo(x, 1, 1)[..., 1:-1, :]
        return x

    outcome = {}

    def call():
        try:
            _run([[("cpu", lambda t=t: work(t)) for t in range(4)]])
        except ValueError as e:
            outcome["error"] = e

    caller = threading.Thread(target=call, daemon=True)
    caller.start()
    caller.join(timeout=60)
    assert not caller.is_alive()
    assert str(outcome["error"]) == "shard 1 failed"
