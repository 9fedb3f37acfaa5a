"""Every wait of the port's row split and transport has a bound, and a
bound that trips raises in the caller, naming what it waited for
(``parallel/rows.py``, ``parallel/transport.py``, ``parallel/mesh.py``).

The bounds are module constants (``rows.TURN_TIMEOUT_S``,
``transport.TIMEOUT_S``, ``spawn_ranks``'s ``timeout_s``), made small
here: a shard stuck inside its job makes ``ShardThreads.run`` raise
naming the shard, its thread is retired and the next run gets a new one;
``close()`` returns within its bound; a rendezvous whose peer never comes
raises within its bound; ``spawn_ranks`` returns at once when a rank
fails, and within its bound when a rank hangs.  A transport wait on a
peer that never sends is a case of ``tests/test_torch_multiprocess.py``'s
group (``no_peer``).  Each case takes a few seconds at most.
"""

import threading
import time

import pytest
import torch

from stereo_tpu_torch.ops import rows
from stereo_tpu_torch.parallel import initialize_distributed
from stereo_tpu_torch.parallel import rows as parallel_rows
from stereo_tpu_torch.parallel import transport
from stereo_tpu_torch.parallel.rows import RowSplitAborted, ShardThreads

import torch_spawn_targets
import torch_threads

torch_threads.take_worker_share()

BOUND_S = 0.5


@pytest.fixture
def small_bound(monkeypatch):
    monkeypatch.setattr(parallel_rows, "TURN_TIMEOUT_S", BOUND_S)


def _halo_shard():
    x = torch.ones(1, 1, 4, 3)
    for _ in range(2):
        x = rows.halo(x, 1, 1)[..., 1:-1, :]
    return x


def _stuck_split(release, stuck=1, tile=3):
    """A split whose shard ``stuck`` waits on ``release`` (at most 30 s)
    inside its job, after its first exchange, and the others exchange."""
    def work(t):
        if t == stuck:
            rows.halo(torch.ones(1, 1, 4, 3), 1, 1)
            release.wait(30)
        return _halo_shard()
    return [("cpu", lambda t=t: work(t)) for t in range(tile)]


def threads_of(threads: ShardThreads) -> list:
    return [thread for _, thread in threads._queues]


def test_stuck_shard_makes_run_raise_naming_it(small_bound):
    release = threading.Event()
    threads = ShardThreads()
    start = time.monotonic()
    try:
        with pytest.raises(RowSplitAborted,
                           match=r"shard 1 of split 0 .*row-shard-1.* held "
                                 r"its turn for more than 0.5 s"):
            threads.run([_stuck_split(release)])
        assert time.monotonic() - start < 3 * BOUND_S + 2
    finally:
        release.set()
        threads.close()


def test_stuck_shard_before_any_exchange_is_named(small_bound):
    """Shard 0, the first to hold the turn, is stuck before it reaches an
    exchange: the run raises naming it, its neighbours never ran."""
    release = threading.Event()
    threads = ShardThreads()
    try:
        with pytest.raises(RowSplitAborted, match=r"shard 0 of split 0"):
            threads.run([[("cpu", lambda: release.wait(30)),
                          ("cpu", _halo_shard)]])
    finally:
        release.set()
        threads.close()


def test_close_after_a_stuck_shard_returns_within_its_bound(small_bound):
    """The stuck thread was retired by the run: ``close()`` stops the
    others and returns at once, while the stuck job has not returned."""
    release = threading.Event()
    threads = ShardThreads()
    try:
        with pytest.raises(RowSplitAborted):
            threads.run([_stuck_split(release)])
        start = time.monotonic()
        threads.close()
        assert time.monotonic() - start < BOUND_S + 1
        assert not release.is_set()
    finally:
        release.set()


def test_threads_run_again_after_a_stuck_shard(small_bound):
    """The stuck shard's thread is replaced: the next run of the same
    split, nothing stuck, gives the whole frame's rows, none dropped; the
    retired thread ends once its job returns."""
    release = threading.Event()
    threads = ShardThreads()

    def named():
        return [t for t in threading.enumerate() if t.name == "row-shard-1"]

    try:
        with pytest.raises(RowSplitAborted):
            threads.run([_stuck_split(release)])
        retired = [t for t in named() if t not in threads_of(threads)]
        assert len(retired) == 1 and retired[0].is_alive()
        results, exchanges = threads.run([[("cpu", _halo_shard)
                                           for _ in range(3)]])
        assert all(torch.equal(r, torch.ones(1, 1, 4, 3))
                   for r in results[0])
        assert exchanges[0].rounds == 2
        release.set()
        retired[0].join(10)
        assert not retired[0].is_alive() and len(named()) == 1
    finally:
        release.set()
        threads.close()


def test_close_with_a_thread_still_in_its_job_raises_within_its_bound(
        small_bound):
    """``close()`` called while a run's shard is still in its job (from
    another thread) waits at most its bound, then names the thread."""
    release = threading.Event()
    entered = threading.Event()
    threads = ShardThreads()
    raised = []

    def call():
        try:
            threads.run([[("cpu", lambda: entered.set() or release.wait(30))]])
        except RowSplitAborted as exc:      # the shard is stuck, too
            raised.append(exc)

    caller = threading.Thread(target=call, daemon=True)
    caller.start()
    try:
        assert entered.wait(10)
        start = time.monotonic()
        with pytest.raises(RuntimeError, match="row-shard-0 still in a job"):
            threads.close()
        assert time.monotonic() - start < BOUND_S + 1
        caller.join(10)     # the run gives its stuck shard up, too
        assert not caller.is_alive() and len(raised) == 1
        assert threads_of(threads) == []
    finally:
        release.set()


def test_rendezvous_without_its_peer_raises_within_its_bound(tmp_path,
                                                             monkeypatch):
    """Rank 0 of two joins a group whose rank 1 never comes: the group's
    timeout (``transport.TIMEOUT_S``) ends the wait, and the error names
    the rank, the world and the address."""
    monkeypatch.setattr(transport, "TIMEOUT_S", 1.0)
    store = f"file://{tmp_path / 'store'}"
    start = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank 0 of 2 joining the group "
                                           r"at file://.*bound 1.0 s"):
        initialize_distributed(store, 2, 0, backend="gloo")
    assert time.monotonic() - start < 6
    assert not torch.distributed.is_initialized()


def test_spawn_ranks_returns_at_once_when_a_rank_fails(tmp_path):
    """Rank 1 raises at once, rank 0 would sleep for a minute:
    ``spawn_ranks`` ends rank 0 and returns well within its bound."""
    start = time.monotonic()
    codes = transport.spawn_ranks(torch_spawn_targets.fail_or_sleep, 2,
                                  str(tmp_path / "store"), args=(60.0,),
                                  timeout_s=60)
    assert codes == [None, 1]
    assert time.monotonic() - start < 8


def test_spawn_ranks_ends_hung_ranks_within_its_bound(tmp_path):
    start = time.monotonic()
    codes = transport.spawn_ranks(torch_spawn_targets.sleep, 2,
                                  str(tmp_path / "store"), args=(60.0,),
                                  timeout_s=2)
    assert codes == [None, None]
    assert time.monotonic() - start < 8
