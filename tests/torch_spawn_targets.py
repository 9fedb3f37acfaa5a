"""Targets of ``parallel.transport.spawn_ranks`` for
``tests/test_torch_bounds.py``.  A spawned child imports the module of its
target, so this one imports nothing heavy: each child starts in well
under a second."""

import time


def sleep(rank, world, init, seconds):
    """Every rank sleeps ``seconds`` (a hung rank)."""
    time.sleep(seconds)


def fail_or_sleep(rank, world, init, seconds):
    """Rank 1 raises at once; the others sleep ``seconds`` (as a rank
    blocked in a collective with it would)."""
    if rank == 1:
        raise RuntimeError("rank 1 failed")
    time.sleep(seconds)
