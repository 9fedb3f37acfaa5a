"""Deep3D's sharded training step (``parallel.train``) across processes on
the CPU: a group of four gloo ranks, spawned once for the module
(``tests/torch_multiprocess_ranks.py``'s ``run_training``), runs the
meshes of :data:`CASES` with their data groups ((2,1,1), (4,1,1)) or a
tile group over two ranks ((1,2,1), (2,2,1)), and the tests compare what
each rank received.  ``tests/test_torch_multiprocess_train_tile.py`` has
the meshes whose tile groups span four ranks or hold two shards a rank,
in a group of its own (two groups, so two workers share them), and
``tests/test_torch_multiprocess.py`` the other cases.

Contract: the step gives, on every rank, the losses, weights and Adam
state of the same mesh in one process bit for bit, with every replica
identical.  The group is joined within a time limit: a hung rank fails
the fixture, it does not hang the run.
"""

import numpy as np
import pytest
import torch

import torch_multiprocess_ranks as ranks
import torch_threads

torch_threads.take_worker_share()

WORLD = 4
CASES = ("train_121", "train_211", "train_221", "train_411")


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every case of :data:`CASES` across the 4 ranks: (each rank's
    results, the one process results of every case)."""
    return ranks.spawn_group(ranks.run_training, CASES, WORLD,
                             str(tmp_path_factory.mktemp("ranks")),
                             timeout_s=240)


@pytest.mark.parametrize("name", CASES)
def test_training_across_processes_equals_one_process(group, name):
    assert_training_equals_one_process(group, name)


def assert_training_equals_one_process(group, name):
    """Every rank, those outside the mesh included, ends each step with
    the loss, weights and Adam state of one process, bit for bit.  Where
    ``tile`` > 1 the step splits rows, and every rank holding a shard
    crosses ranks in each round of the forward and of the backward."""
    got, want = group
    shape, entries = ranks.TRAIN_CASES[name]
    assert want[name]["replicas"] == 1 and want[name]["replicas_identical"]
    assert want[name]["row_split"] == (shape[1] > 1)
    for rank, results in enumerate(got):
        case = results[name]
        assert torch.equal(case["losses"], want[name]["losses"]), rank
        assert case["digest"] == want[name]["digest"], rank
        assert case["replicas"] == 1 and case["replicas_identical"], rank
        assert case["row_split"] == want[name]["row_split"], rank
    if shape[1] == 1:
        return
    rounds = want[name]["halo"]["rounds"]
    assert rounds > 0 and want[name]["halo"]["back_rounds"] == rounds
    assert want[name]["halo"]["cross_rounds"] == 0
    held = [r[name]["halo"] for r in got if r[name]["halo"] is not None]
    owners = np.repeat(np.arange(WORLD), entries)[:np.prod(shape)]
    assert len(held) == len(set(owners))
    for h in held:
        assert (h["rounds"] == h["cross_rounds"] == h["back_rounds"]
                == h["back_cross_rounds"] == rounds), h
        assert h["back_cross_bytes"] > 0 and h["cross_bytes"] > 0, h
