"""The port's mesh across processes (``stereo_tpu_torch.parallel`` under a
``torch.distributed`` group, ``parallel/transport.py``) on the CPU: one
group of four gloo ranks, spawned once for the module
(``tests/torch_multiprocess_ranks.py``), runs every case, and the tests
compare what each rank received.

Contract (JAX's, for its engines across hosts): on integer-valued pairs
(and on the real pairs, whose sums are the same ones) each engine across
processes equals the same mesh in one process bit for bit, on every rank;
that mesh equals the single device and is held to JAX at 1e-4
(``tests/test_torch_parallel.py``), and one case is held to JAX's
``ShardedClassicalEngine`` here too.  A row split whose ``tile`` group
spans ranks is refused with ``ValueError``.  The group is joined within
a time limit: a hung rank fails the fixture, it does not hang the run.
"""

import numpy as np
import pytest
import torch

from stereo_tpu.core.config import MatchingConfig as JaxMatchingConfig
from stereo_tpu.core.config import MeshConfig as JaxMeshConfig
from stereo_tpu.parallel import ShardedClassicalEngine as JaxShardedEngine

from stereo_tpu_torch.parallel.classical import _all_gather_rows
from stereo_tpu_torch.parallel.transport import spawn_ranks

import torch_multiprocess_ranks as ranks

WORLD = 4
NAMES = sorted(ranks.CASES) + sorted(ranks.REFUSED)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every case across the 4 ranks: (each rank's results, rank 0's one
    process results)."""
    out = tmp_path_factory.mktemp("ranks")
    codes = spawn_ranks(ranks.run, WORLD, str(out / "store"),
                        args=(str(out), NAMES), timeout_s=240)
    errors = {p.name: p.read_text() for p in out.glob("rank*.err")}
    assert codes == [0] * WORLD, (codes, errors)
    return ([torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)],
            torch.load(out / "one_process.pt", weights_only=False))


@pytest.mark.parametrize("name", sorted(ranks.CASES))
def test_case_across_processes_equals_one_process(group, name):
    got, want = group
    assert want[name]
    for rank, results in enumerate(got):
        assert results[name].keys() == want[name].keys()
        for key, value in want[name].items():
            assert torch.equal(results[name][key], value), (rank, key)


def test_paths_taken(group):
    """The classical cases take the path their name says; GwcNet and the
    single view split rows within a rank or deal frames across them."""
    _, want = group
    for name in ranks.CASES:
        if "kernels" in name:
            assert bool(want[name]["kernel_path"]), name
        elif "blockwise" in name:
            assert not bool(want[name]["kernel_path"]), name
        elif "split" in name:
            assert bool(want[name]["row_split"]), name
        elif "dealt" in name:
            assert not bool(want[name]["row_split"]), name


def test_classical_across_processes_matches_jax(group):
    got, _ = group
    left, right = (x.numpy() for x in ranks.integer_batch(ranks.CFG))
    jax_engine = JaxShardedEngine(JaxMatchingConfig(**ranks.CFG),
                                  JaxMeshConfig(1, 4, 1))
    want = np.asarray(jax_engine.compute_disparity_maps(left, right))
    for name in ("classical_kernels_141", "classical_blockwise_141"):
        np.testing.assert_allclose(got[0][name]["disparity"].numpy(), want,
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(ranks.REFUSED))
def test_row_split_across_processes_is_refused(group, name):
    got, _ = group
    for results in got:
        assert results[name] is not None, "no ValueError"
        assert "(1, 2, 1)" in results[name] and "span" in results[name]


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
