"""The port's mesh across processes (``stereo_tpu_torch.parallel`` under a
``torch.distributed`` group, ``parallel/transport.py``) on the CPU: one
group of four gloo ranks, spawned once for the module
(``tests/torch_multiprocess_ranks.py``'s ``run``), runs every case, and
the tests compare what each rank received.  Deep3D's sharded training
step across the ranks has a group of its own
(``tests/test_torch_multiprocess_train.py``).

Contract (JAX's, for its engines across hosts): on integer-valued pairs
(and on the real pairs, whose sums are the same ones) each engine across
processes equals the same mesh in one process bit for bit, on every rank;
that mesh equals the single device and is held to JAX at 1e-4
(``tests/test_torch_parallel.py``), and one case is held to JAX's
``ShardedClassicalEngine`` here too.  A row split whose ``tile`` group
spans ranks (GSPMD's row split across hosts) runs each rank's shards and
crosses ranks at every halo exchange: equal bit for bit to one process,
with as many exchanges, each crossing ranks, and the bytes read from
neighbours split between the ranks; one such GwcNet split is held to
JAX's ``ShardedDnnEngine`` at its 5e-3 px; each funnel split over two
ranks matches the whole frame at the 1e-5 of
``tests/test_torch_row_split.py``, and so does its input gradient from a
seeded gradient of each shard's output rows (``conv2d``, ``gather``,
``upsample_bilinear``, and a halo whose received rows get no gradient);
an exchange out of step, or a rank whose shard fails, raises on both
ranks, in the forward and in the backward; a transport wait whose peer
never sends raises within the transport's bound, naming the peer.  The
group is joined within a time limit: a hung rank fails the fixture, it
does not hang the run.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stereo_tpu.core.config import MatchingConfig as JaxMatchingConfig
from stereo_tpu.core.config import MeshConfig as JaxMeshConfig
from stereo_tpu.models import load_params_npz
from stereo_tpu.parallel import ShardedClassicalEngine as JaxShardedEngine
from stereo_tpu.parallel import ShardedDnnEngine as JaxShardedDnnEngine

from stereo_tpu_torch.ops import rows
from stereo_tpu_torch.parallel.classical import _all_gather_rows
from stereo_tpu_torch.utils.paths import model_checkpoint_dir

import torch_multiprocess_ranks as ranks
import torch_threads

torch_threads.take_worker_share()

WORLD = 4
NAMES = sorted(ranks.CASES)


def tile_group_spans_ranks(name) -> bool:
    """Whether a tile group of case ``name``'s mesh lies on more than one
    rank (``make_mesh`` takes the ranks' entries in rank order)."""
    _, shape, entries, _ = ranks.CASES[name]
    if entries is None:
        return False
    owners = np.repeat(np.arange(WORLD), entries)[:np.prod(shape)]
    return any(len(set(group)) > 1
               for group in owners.reshape(shape).transpose(0, 2, 1)
               .reshape(-1, shape[1]))


# The row splits whose tile group spans ranks.
SPANNING = [n for n in NAMES if "split" in n and tile_group_spans_ranks(n)]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every case across the 4 ranks: (each rank's results, the one
    process results of every case)."""
    return ranks.spawn_group(ranks.run, NAMES, WORLD,
                             str(tmp_path_factory.mktemp("ranks")),
                             timeout_s=240)


@pytest.mark.parametrize("name", sorted(ranks.CASES))
def test_case_across_processes_equals_one_process(group, name):
    got, want = group
    assert want[name]
    for rank, results in enumerate(got):
        assert results[name].keys() == want[name].keys()
        for key, value in want[name].items():
            assert torch.equal(results[name][key], value), (rank, key)


def test_paths_taken(group):
    """The classical cases take the path their name says; GwcNet, the
    MSNets and the single view split rows (within a rank or across ranks)
    or deal frames across them.  A split across ranks exchanges as often
    as one process does, and every exchange crosses ranks; a split within
    a rank crosses none."""
    got, want = group
    for name in ranks.CASES:
        if "kernels" in name:
            assert bool(want[name]["kernel_path"]), name
        elif "blockwise" in name:
            assert not bool(want[name]["kernel_path"]), name
        elif "split" in name:
            assert bool(want[name]["row_split"]), name
            rounds = want["halo"][name]["rounds"]
            assert rounds > 0 and want["halo"][name]["cross_rounds"] == 0
            held = [r["halo"][name] for r in got
                    if r["halo"][name] is not None]
            assert held and all(h["rounds"] == rounds for h in held), name
            crossing = rounds if name in SPANNING else 0
            assert all(h["cross_rounds"] == crossing for h in held), name
        elif "dealt" in name:
            assert not bool(want[name]["row_split"]), name


@pytest.mark.parametrize("name", SPANNING)
def test_split_across_ranks_bytes_add_up(group, name):
    """The bytes each rank's shards read from neighbours add up to one
    process's, and every byte a rank read crossed ranks except those of
    its own shards' common edges (none where a rank holds one shard)."""
    got, want = group
    held = [r["halo"][name] for r in got if r["halo"][name] is not None]
    assert sum(h["bytes"] for h in held) == want["halo"][name]["bytes"]
    assert all(0 < h["cross_bytes"] <= h["bytes"] for h in held)
    _, shape, entries, _ = ranks.CASES[name]
    if max(entries) == 1 and shape[0] == 1:
        assert all(h["cross_bytes"] == h["bytes"] for h in held)


def test_gwcnet_split_across_ranks_matches_jax(group):
    """GwcNet on (1,2,1), one shard a rank, against JAX's GSPMD engine on
    the same mesh, on every rank."""
    got, _ = group
    left = np.random.default_rng(0).uniform(0, 255, (4, 3, 64, 96)).astype(
        np.float32)[:1]
    jax_engine = JaxShardedDnnEngine(
        "gwcnet", (64, 96), JaxMeshConfig(data=1, tile=2, disp=1),
        max_disparity=16,
        params=load_params_npz(model_checkpoint_dir("gwcnet") + ".npz"))
    want = np.asarray(jax_engine.process_batch(
        left, np.roll(left, -3, axis=-1).copy()))[0]
    for results in got:
        case = results["gwcnet_split_121"]
        for out in (case["single"], case["disparity"][0]):
            np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=5e-3)


def whole_frame_funnel(name, x, w):
    """Funnel ``name``'s two shards' outputs, joined, computed on the
    whole frame ``x``."""
    per = x.shape[-2] // 2
    if name == "halo_own_rows":
        return x
    if name.startswith("halo"):
        above, below = {"halo_zeros": (1, 2), "halo_replicate": (2, 1),
                        "halo_none": (1, 1)}[name]
        if name == "halo_none":
            return torch.cat([x[..., :per + below, :],
                              x[..., per - above:, :]], dim=-2)
        if name == "halo_zeros":
            padded = F.pad(x, (0, 0, above, below))
        else:
            padded = torch.cat([x[..., :1, :]] * above + [x]
                               + [x[..., -1:, :]] * below, dim=-2)
        return torch.cat([padded[..., t * per:(t + 1) * per + above + below,
                                 :] for t in range(2)], dim=-2)
    if name == "conv2d":
        return F.conv2d(x, w, padding=1)
    if name == "interpolate":
        return F.interpolate(x, size=(x.shape[-2] * 4, 12), mode="bilinear",
                             align_corners=False)
    if name == "upsample_bilinear":
        return rows.upsample_bilinear(x, 2)   # outside a split
    return torch.cat([x, x], dim=-2)        # gather: the frame on each


@pytest.mark.parametrize("name", sorted(ranks.FUNNELS))
def test_funnel_across_ranks_matches_whole(group, name):
    got, _ = group
    x, w = ranks.funnel_input(name)
    shards = [got[r]["funnels"][name] for r in ranks.FUNNEL_RANKS]
    joined = torch.cat([s["rows"] for s in shards], dim=-2)
    torch.testing.assert_close(joined, whole_frame_funnel(name, x, w),
                               rtol=0, atol=1e-5)
    for s in shards:
        assert s["rounds"] == s["cross_rounds"] == 1 and s["cross_bytes"] > 0
    assert all(got[r]["funnels"][name] is None for r in range(WORLD)
               if r not in ranks.FUNNEL_RANKS)


@pytest.mark.parametrize("name", ranks.GRAD_FUNNELS)
def test_funnel_gradient_across_ranks_matches_whole(group, name):
    """Each shard's input gradient, from a seeded gradient of its output
    rows, joined: the whole frame's input gradient from those gradients
    joined, at the forward's 1e-5; each rank's backward crossed ranks
    once, receiving rows (zeros where the rows received were dropped)."""
    got, _ = group
    x, w = ranks.funnel_input(name)
    shards = [got[r]["funnels"][name] for r in ranks.FUNNEL_RANKS]
    whole = x.clone().requires_grad_()
    out = whole_frame_funnel(name, whole, w)
    out.backward(torch.cat([ranks.upstream(name, t, s["rows"].shape)
                            for t, s in enumerate(shards)], dim=-2))
    joined = torch.cat([s["grad"] for s in shards], dim=-2)
    torch.testing.assert_close(joined, whole.grad, rtol=0, atol=1e-5)
    for s in shards:
        assert s["back_rounds"] == s["back_cross_rounds"] == 1
        assert s["back_cross_bytes"] > 0


def test_exchange_out_of_step_across_ranks_raises_on_both(group):
    """Shards of two ranks exchanging under different keys (edge rules):
    each rank's shard sees the other's digest disagree and raises."""
    got, _ = group
    for r in ranks.FUNNEL_RANKS:
        kind, message, _ = got[r]["funnels"]["out_of_step"]
        assert kind == "RuntimeError" and "out of step" in message
        assert f"from rank {1 - r}" in message


def test_backward_out_of_step_across_ranks_raises_on_both(group):
    """Two runs in step, whose backward rank 0 takes in one order and rank
    1 in the other: each rank's backward sees the other's key digest
    disagree and raises."""
    got, _ = group
    for r in ranks.FUNNEL_RANKS:
        kind, message, _ = got[r]["funnels"]["out_of_step_backward"]
        assert kind == "RuntimeError", message
        assert "out of step in backward" in message, message
        assert f"from rank {1 - r}" in message


def test_hung_backward_across_ranks_ends_its_peer_within_the_timeout(group):
    """Rank 1 never runs the backward of a run both ranks ran forward: rank
    0's backward, waiting for its rows' gradients, gives up after the
    run's 2 s timeout instead of blocking."""
    got, _ = group
    assert got[1]["funnels"]["hung_backward"] is None
    kind, message, seconds = got[0]["funnels"]["hung_backward"]
    assert kind == "RuntimeError" and "Timed out" in message, message
    assert 1.5 < seconds < 30


def test_failing_shard_across_ranks_ends_its_peer_within_the_timeout(group):
    """Rank 1's shard raises before its first exchange: it reports its own
    error, and rank 0's shard, waiting for its rows, gives up after the
    2 s timeout instead of blocking."""
    got, _ = group
    kind, message, _ = got[1]["funnels"]["failing_shard"]
    assert kind == "ZeroDivisionError"
    kind, message, seconds = got[0]["funnels"]["failing_shard"]
    assert kind == "RuntimeError" and "Timed out" in message, message
    assert 1.5 < seconds < 30


def test_transport_wait_without_a_peer_raises_within_its_bound(group):
    """Rank 0 waits for rows that rank 1 never sends, under the
    transport's own bound (no timeout given): it raises within the bound,
    naming the line and the rank it waited for."""
    got, _ = group
    kind, message, seconds = got[0]["no_peer"]
    assert kind == "RuntimeError", message
    assert ("rank 0: ring_fetch over ranks [0, 1], messages with ranks [1] "
            f"(bound {ranks.NO_PEER_TIMEOUT_S} s)") in message, message
    assert ranks.NO_PEER_TIMEOUT_S * 0.75 < seconds < 10
    assert all(results["no_peer"] is None for results in got[1:])


def test_classical_across_processes_matches_jax(group):
    got, _ = group
    left, right = (x.numpy() for x in ranks.integer_batch(ranks.CFG))
    jax_engine = JaxShardedEngine(JaxMatchingConfig(**ranks.CFG),
                                  JaxMeshConfig(1, 4, 1))
    want = np.asarray(jax_engine.compute_disparity_maps(left, right))
    for name in ("classical_kernels_141", "classical_blockwise_141"):
        np.testing.assert_allclose(got[0][name]["disparity"].numpy(), want,
                                   rtol=0, atol=1e-4)


def test_make_mesh_global_order(group):
    """Ranks listing 2, 1, 1, 1 devices: the mesh takes them in rank order,
    each rank holds its own entries, results land on its first device,
    and a mesh larger than all the lists together raises on every rank."""
    got, _ = group
    for rank, results in enumerate(got):
        order = results["mesh_order"]
        assert order["processes"] == [[[0], [0], [1], [2], [3]]]
        starts = np.cumsum((0,) + ranks.ORDER_COUNTS)
        assert order["local"] == [(0, t, 0) for t in range(
            starts[rank], starts[rank + 1])]
        assert order["first_device"] == "cpu"
        assert "wants 6 devices but only 5 present" in order["error"]


def test_initialize_distributed_without_address_is_a_no_op_in_a_group(group):
    got, _ = group
    assert [results["world_size"] for results in got] == [WORLD] * WORLD


class GatheringLine:
    """A ring's line whose all-gather hands back ``parts`` on the device
    asked for, as ``Transport.all_gather_parts`` does."""

    def __init__(self, parts):
        self.parts = parts

    def all_gather(self, xs, device):
        return [p.to(device) for p in self.parts]


def test_all_gather_rows_lands_on_each_local_device():
    """A rank holding two shards on distinct devices of a ring that crosses
    ranks gets the gathered rows on each shard's own device (``meta``
    stands in for a second card)."""
    parts = [torch.full((2, 3), float(i)) for i in range(4)]
    xs = [parts[0], parts[1].to("meta"), None, None]
    out = _all_gather_rows(xs, GatheringLine(parts))
    assert out[2] is None and out[3] is None
    assert out[0].device.type == "cpu" and torch.equal(out[0],
                                                       torch.cat(parts))
    assert out[1].device.type == "meta" and out[1].shape == (8, 3)
