"""One pytest-xdist worker's share of the CPUs for torch, which the port's
test modules take at import (every worker imports every module when it
collects).

Torch's intra-op pool defaults to every CPU in every process: beside the
suite's other workers each parallel region's threads then wait on each
other, and a file ran 2-3 times as long as alone.  Under xdist a worker
takes one thread: the share of 8 CPUs over 6 workers, and the count at
which the in-process bit-equality tests hold (the sharded GwcNet of
``tests/test_torch_parallel_dnn.py`` equals its single device bit for bit
at one thread and at eight, not at two).  Without xdist torch keeps every
CPU.  The processes a test starts (the entry points run as scripts) take
the same share through ``OMP_NUM_THREADS``; the spawned ranks of the
multi-process tests set one thread each themselves.
"""

import os

import torch


def take_worker_share() -> None:
    """Cap torch's intra-op threads, and those of the processes started
    from here, at this worker's share: one under xdist, else every CPU."""
    if int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")) > 1:
        share = 1
    else:
        share = len(os.sched_getaffinity(0))
    if torch.get_num_threads() > share:
        torch.set_num_threads(share)
    os.environ.setdefault("OMP_NUM_THREADS", str(share))
