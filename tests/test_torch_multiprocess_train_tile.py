"""Deep3D's sharded training step across processes on the CPU, the meshes
whose tile group spans all four ranks ((1,4,1)), or two ranks with two
shards each ((1,4,1) over ranks 0 and 1), or all four with two shards each
((1,8,1), 4 down rows a shard): a group of four gloo ranks of its own,
spawned once for the module (``tests/torch_multiprocess_ranks.py``'s
``run_training``), under the contract of
``tests/test_torch_multiprocess_train.py``: on every rank, the losses,
weights and Adam state of the same mesh in one process bit for bit.
"""

import pytest

import torch_multiprocess_ranks as ranks
from test_torch_multiprocess_train import (WORLD,
                                           assert_training_equals_one_process)
import torch_threads

torch_threads.take_worker_share()

CASES = ("train_141", "train_141_mixed", "train_181")


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
