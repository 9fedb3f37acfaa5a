"""Deep3D's rows split over ``tile`` in the sharded single view
(``stereo_tpu_torch/parallel/synthesis.py``; its funnels in ``ops/rows.py``,
the network's routing in ``models/deep3d.py``, the shard's synthesis in
``synthesis/right_view_synthesis.py``) on the CPU, at the JAX test size:
Deep3D at 128x256 / 32x64, views of 64x96 (``tests/test_parallel_synthesis.py``).

Each funnel split by rows at tile 2, 4 and 8 (one-row shards) is held to
the whole frame within 1e-5, and at tile 8 the gradients of the funnels
that read a neighbour's row too; ``prob_volume_low`` split at tile 2 (the
gather before VggBlock_4's pool), tile 4 (before VggBlock_3's), tile 8
(before VggBlock_2's) and tile 32 (one down row a shard: the gather
before VggBlock_0's pool, the volume narrowed) to the single device within
1e-5; the engine on (1,2,1), (1,4,1) and (2,2,1) to the port's single
device and to JAX's ``ShardedSingleViewEngine`` (GSPMD on the 8 virtual
devices of ``tests/conftest.py``) at JAX's gate: at least 99% of pixels
within 0.5 px and a mean under 0.1 px; and on (1,8,1), which JAX splits
too, to the single device frame by frame.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu.core.config import MeshConfig as JaxMeshConfig
from stereo_tpu.parallel import (
    ShardedSingleViewEngine as JaxShardedSingleViewEngine)
from stereo_tpu.synthesis import RightViewSynthesis as JaxRightViewSynthesis
from test_parallel_synthesis import _matching_config

from stereo_tpu_torch.core.config import MatchingConfig, MeshConfig
from stereo_tpu_torch.matching.classical import ClassicalStereoEngine
from stereo_tpu_torch.models import (deep3d_state_dict_from_flax,
                                     flax_arrays_from_state_dict)
from stereo_tpu_torch.models.deep3d import Conv3x3, VggBlock
from stereo_tpu_torch.models.layers import Deconv2dParity
from stereo_tpu_torch.ops import rows
from stereo_tpu_torch.ops.cuda import LAUNCHES, capturing_counts
from stereo_tpu_torch.ops.cuda.launch import count_launch
from stereo_tpu_torch.parallel import (ShardedDnnEngine,
                                       ShardedSingleViewEngine, make_mesh)
from stereo_tpu_torch.parallel.rows import ShardThreads
from stereo_tpu_torch.synthesis import RightViewSynthesis
from stereo_tpu_torch.synthesis.right_view_synthesis import (
    fused_blend_tail, resize_nchw, split_blend, synthesize_rows)

import torch_threads

torch_threads.take_worker_share()

H, W = 64, 96
FULL, DOWN = (128, 256), (32, 64)


def _randn(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _run(splits):
    threads = ShardThreads()
    try:
        return threads.run(splits)
    finally:
        threads.close()


def _split(fn, tile, *xs):
    """``fn`` on ``tile`` row shards of each of ``xs`` (rows axis -2) in a
    row split on the CPU: the shards' outputs joined along the rows, and
    the split's exchange."""
    def shard(t):
        return fn(*(x.narrow(-2, t * (x.shape[-2] // tile),
                             x.shape[-2] // tile) for x in xs))
    results, exchanges = _run([[("cpu", lambda t=t: shard(t))
                                for t in range(tile)]])
    return torch.cat(results[0], dim=-2), exchanges[0]


def _blend_inputs(scale, seed):
    prob = torch.softmax(_randn(2, 65, 8, 12, seed=seed), dim=1)
    view = torch.rand(2, 3, 8 * scale, 12 * scale,
                      generator=torch.Generator().manual_seed(seed))
    return prob, view


def _seeded(make):
    """``make()`` with torch's generator seeded, the global one untouched."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return make()


_CONV = _seeded(lambda: Conv3x3(4, 5))
_VGG = _seeded(lambda: VggBlock(4, (6, 6)))
_DECONV = {s: _seeded(lambda s=s: Deconv2dParity(4, 3, s))
           for s in (2, 4, 8, 16)}

# Deep3D's funnels: (inputs, function).
FUNNELS = {
    "conv3x3": (lambda: (_randn(2, 4, 16, 12),), _CONV),
    "vgg_block": (lambda: (_randn(1, 4, 16, 12),), _VGG),
    "gather_narrow": (lambda: (_randn(2, 3, 8, 5),),
                      lambda x: rows.narrow(rows.gather(x) * 2.0)),
    **{f"deconv_s{s}": (lambda: (_randn(1, 4, 8, 6),), _DECONV[s])
       for s in (2, 4, 8, 16)},
    **{f"blend_s{s}": (lambda s=s: _blend_inputs(s, s),
                       lambda p, v, s=s: split_blend(p, v, s))
       for s in (2, 4)},
}


@pytest.mark.parametrize("tile", [2, 4, 8])
@pytest.mark.parametrize("funnel", sorted(FUNNELS))
def test_funnel_split_matches_whole(funnel, tile):
    make, fn = FUNNELS[funnel]
    xs = make()
    with torch.no_grad():
        want = fn(*xs)
        got, _ = _split(fn, tile, *xs)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


# The funnels that read a neighbour's row, on shards of one row (tile 8):
# name -> (input shape, weight shape or None, function of a shard's rows).
ONE_ROW_GRADS = {
    "conv2d": ((2, 3, 8, 6), (4, 3, 3, 3), rows.conv2d),
    "upsample_bilinear": ((1, 2, 8, 6), None,
                          lambda x, w: rows.upsample_bilinear(x, 4)),
    "neighbour_rows": ((1, 2, 8, 5), None,
                       lambda x, w: rows.neighbour_rows(x)[0]),
}


def _neighbour_rows_whole(x, w):
    """The whole frame's counterpart of ``neighbour_rows`` on one-row
    shards: shard t's row with those of shards t - 1 and t + 1 inside the
    frame, the shards' outputs joined."""
    n = x.shape[-2]
    return torch.cat([x[..., max(t - 1, 0):t + 2, :] for t in range(n)],
                     dim=-2)


@pytest.mark.parametrize("funnel", sorted(ONE_ROW_GRADS))
def test_one_row_shards_carry_gradient_back(funnel):
    """At tile 8 on 8 rows each shard holds one row, read by both of its
    neighbours: the shards' outputs and, from a seeded gradient of them,
    the input's (and the weight's) gradient equal the whole frame's
    within 1e-5."""
    shape, wshape, fn = ONE_ROW_GRADS[funnel]
    x = _randn(*shape, seed=len(funnel)).requires_grad_()
    w = (None if wshape is None
         else _randn(*wshape, seed=1).requires_grad_())
    whole = {"conv2d": lambda x, w: torch.nn.functional.conv2d(
                 x, w, padding=1),
             "upsample_bilinear": lambda x, w: torch.nn.functional.interpolate(
                 x, scale_factor=4, mode="bilinear", align_corners=False),
             "neighbour_rows": _neighbour_rows_whole}[funnel]
    leaves = [v for v in (x, w) if v is not None]
    want = whole(x, w)
    upstream = _randn(*want.shape, seed=2)
    want_grads = torch.autograd.grad((want * upstream).sum(), leaves)
    threads = ShardThreads()
    try:
        with torch.enable_grad():
            results, exchanges = threads.run([[("cpu", lambda t=t: fn(
                x.narrow(-2, t, 1), w)) for t in range(8)]])
            got = torch.cat(results[0], dim=-2)
            loss = rows.tie((got * upstream).sum(), exchanges[0].token)
            got_grads = torch.autograd.grad(loss, leaves)
    finally:
        threads.close()
    assert exchanges[0].back.rounds == exchanges[0].rounds == 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    for g, want_g in zip(got_grads, want_grads):
        torch.testing.assert_close(g, want_g, rtol=0, atol=1e-5)


def test_neighbour_rows_and_pool_rule():
    """Each shard gains its neighbours' edge rows and none beyond the
    frame; a shard of odd rows refuses to pool."""
    x = torch.arange(8 * 3, dtype=torch.float32).view(1, 1, 8, 3)
    results, _ = _run([[("cpu", lambda t=t: rows.neighbour_rows(
        x[..., 2 * t:2 * t + 2, :])) for t in range(4)]])
    assert [above for _, above in results[0]] == [0, 1, 1, 1]
    assert [part.shape[-2] for part, _ in results[0]] == [3, 4, 4, 3]
    assert torch.equal(results[0][1][0], x[..., 1:5, :])
    assert torch.equal(results[0][3][0], x[..., 5:, :])
    with pytest.raises(ValueError, match="does not pool"):
        _split(rows.max_pool2d, 8, torch.zeros(1, 1, 8, 4))


@pytest.fixture(scope="module")
def deep3d():
    """Seeded Deep3D weights in the Flax layout (the port's seeded model
    through ``flax_arrays_from_state_dict``: no Flax init to compile),
    carried to the port by ``deep3d_state_dict_from_flax`` and to JAX as
    its variables tree, with both packages' syntheses on them."""
    seeded = RightViewSynthesis(output_shape=(H, W), seed=0,
                                model_full_shape=FULL, model_down_shape=DOWN,
                                device="cpu")
    arrays = flax_arrays_from_state_dict(seeded.model)
    synthesis = RightViewSynthesis(
        output_shape=(H, W), state_dict=deep3d_state_dict_from_flax(arrays),
        model_full_shape=FULL, model_down_shape=DOWN, device="cpu")
    variables = {}
    for key, arr in arrays.items():
        *path, leaf = re.findall(r"\['([^']+)'\]", key)
        node = variables
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    jax_synthesis = JaxRightViewSynthesis(output_shape=(H, W),
                                          variables=variables,
                                          model_full_shape=FULL,
                                          model_down_shape=DOWN)
    return synthesis, jax_synthesis


@pytest.fixture(scope="module")
def jax_engines(deep3d):
    """JAX's engine per mesh, each built once for the module."""
    _, jax_synthesis = deep3d
    engines = {}

    def get(mesh):
        if mesh not in engines:
            engines[mesh] = JaxShardedSingleViewEngine(
                _matching_config(), JaxMeshConfig(*mesh),
                synthesis=jax_synthesis)
        return engines[mesh]
    return get


def _left(batch, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (batch, 3, H, W)).astype(np.float32)


def _config():
    return MatchingConfig(**dataclasses.asdict(_matching_config()))


def _engine(synthesis, mesh):
    mc = MeshConfig(*mesh)
    return ShardedSingleViewEngine(
        _config(), mc, mesh=make_mesh(mc, ["cpu"] * mc.num_devices),
        synthesis=synthesis)


def _gate(got, want):
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert np.mean(diff <= 0.5) >= 0.99 and diff.mean() < 0.1, (
        f"{np.mean(diff <= 0.5)} within 0.5 px, mean {diff.mean()}")


@pytest.mark.parametrize("tile", [2, 4, 8])
def test_prob_volume_low_split_matches_single_device(deep3d, tile):
    """At tile 2 a shard's 16 down rows pool whole through VggBlock_3 and
    gather before VggBlock_4's pool; at tile 4 its 8 rows gather before
    VggBlock_3's pool; at tile 8 its 4 rows before VggBlock_2's."""
    model = deep3d[0].model
    left = torch.from_numpy(_left(2, tile))
    full = resize_nchw(left, FULL) / 255.0
    down = resize_nchw(left, DOWN) / 255.0
    with torch.no_grad():
        want = model.prob_volume_low(down)
        got, exchange = _split(model.prob_volume_low, tile, down)
        right, _ = _split(lambda f, d: synthesize_rows(model, f, d), tile,
                          full, down)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert exchange.rounds > 0 and exchange.bytes > 0
    # The shards' blends against the whole frame's tail (0..255).
    torch.testing.assert_close(right, fused_blend_tail(want, full, 4, FULL,
                                                       FULL),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("mesh", [(1, 2, 1), (1, 4, 1), (2, 2, 1)])
def test_engine_matches_single_device_and_jax(deep3d, jax_engines, mesh):
    synthesis, _ = deep3d
    engine = _engine(synthesis, mesh)
    assert engine.row_split and not engine.graph_splits
    left = _left(2, sum(mesh))
    out, right = engine.process_batch(left, return_right=True)
    assert out.shape == (2, H, W) and right.shape == (2, 3, H, W)
    assert engine.halo["rounds"] > 0 and engine.halo["bytes"] > 0
    # The single device: the batch's views, then the matcher per frame.
    want_right = synthesis.process_batch(torch.from_numpy(left))
    matcher = ClassicalStereoEngine(_config(), device="cpu")
    want = torch.stack([matcher.compute_disparity_map(l, r) for l, r in
                        zip(torch.from_numpy(left), want_right)])
    # 0..255 views: float rounding of the split convolutions.
    torch.testing.assert_close(right, want_right, rtol=0, atol=1e-3)
    _gate(out, want)
    jax_out, jax_right = jax_engines(mesh).process_batch(left,
                                                         return_right=True)
    # The bf16 global branch rounds at other points in the two packages
    # (tests/test_torch_synthesis.py: below 0.1 grey levels).
    np.testing.assert_allclose(right.numpy(), np.asarray(jax_right),
                               rtol=0, atol=0.1)
    _gate(out, jax_out)


def test_odd_shard_rows_gather_first_and_narrow_the_volume(deep3d):
    """At tile 32 a shard holds one of the 32 down rows: it gathers before
    VggBlock_0's pool (after that block's two convolutions: three
    exchanges in all), its branch predictions at down/2 do not split over
    the shards, so the sum and the head run on the whole frame and the
    softmax volume is narrowed to the shard's row.  The volume within 1e-5
    of the single device's, the shards' blends within 1e-3 grey levels."""
    model = deep3d[0].model
    left = torch.from_numpy(_left(1, 32))
    full = resize_nchw(left, FULL) / 255.0
    down = resize_nchw(left, DOWN) / 255.0
    with torch.no_grad():
        want = model.prob_volume_low(down)
        got, exchange = _split(model.prob_volume_low, 32, down)
        right, _ = _split(lambda f, d: synthesize_rows(model, f, d), 32,
                          full, down)
    assert exchange.rounds == 3
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(right, fused_blend_tail(want, full, 4, FULL,
                                                       FULL),
                               rtol=0, atol=1e-3)


def test_tile_8_splits_rows_as_jax_does(deep3d):
    """At tile 8 a shard holds 4 of the 32 down rows, which JAX's GSPMD
    splits too: the engine splits the rows (gathering before VggBlock_2's
    pool) and equals the single device frame by frame, the views within
    float rounding of the split convolutions, the disparities at JAX's
    gate."""
    synthesis, _ = deep3d
    engine = _engine(synthesis, (1, 8, 1))
    assert engine.row_split
    left = _left(2, 3)
    out, right = engine.process_batch(left, return_right=True)
    assert engine.halo is not None and engine.halo["rounds"] > 0
    matcher = ClassicalStereoEngine(_config(), device="cpu")
    for i in range(2):
        r = synthesis.process(torch.from_numpy(left[i]))
        torch.testing.assert_close(right[i], r, rtol=0, atol=1e-3)
        _gate(out[i], matcher.compute_disparity_map(left[i], r))


def test_cpu_meshes_run_splits_eagerly(deep3d):
    """Graphs are for a mesh of one card: a CPU mesh runs the shard
    threads eagerly, and the single device keeps no split."""
    synthesis, _ = deep3d
    assert not _engine(synthesis, (1, 2, 1)).graph_splits
    assert not _engine(synthesis, (2, 1, 1)).row_split
    mc = MeshConfig(tile=2)
    dnn = ShardedDnnEngine("gwcnet", (H, W), mc,
                           mesh=make_mesh(mc, ["cpu"] * 2), max_disparity=16)
    assert dnn.row_split and not dnn.graph_splits
    assert dnn.graphs_captured == 0


def test_shard_launches_go_to_the_capturing_graph():
    """While the caller captures a graph, its shard threads' launches are
    counted in the graph's counts, not in ``LAUNCHES``."""
    before = dict(LAUNCHES)
    with capturing_counts() as counts:
        _run([[("cpu", lambda: count_launch("upsample_blend"))
               for _ in range(3)]])
    assert counts["upsample_blend"] == 3
    assert LAUNCHES == before
