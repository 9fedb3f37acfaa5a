"""The threads that run a row split: each shard of a frame's rows runs the
whole network in a thread of its own, and the networks' row-mixing layers
exchange halo rows with the neighbouring shards (``ops.rows``, which says
what each layer reads).

The shard threads of a run take turns, one at a time, as the one thread
that drives the rest of the port's mesh does: a shard runs until its next
exchange, publishes its tensor there and hands the turn to the next thread
of the ring.  Launches are asynchronous, so shards on several cards still
overlap on the devices, and no thread waits on the interpreter lock for
another that is launching.  The threads live as long as their
:class:`ShardThreads`: PyTorch keeps cuDNN's execution plans per thread,
and a new thread plans every convolution anew.  A shard that raises marks
the run failed: the others raise at their next turn, and
:meth:`ShardThreads.run` raises the first shard's error.

A split may have shards in other processes (a mesh over
``torch.distributed`` ranks): this process runs threads for its own
shards only, and the exchanges cross ranks through the split's ``Line``
(``ops.rows.Rounds``).  A process that holds shards of several such
splits crosses them in one order, from the thread that holds the turn.
A cross-rank wait is bounded by ``TURN_TIMEOUT_S`` too: a process whose
shard failed leaves its peers waiting that long at most, and they raise.
Under grad mode each exchange is an autograd node whose backward
crosses ranks again (``ops.rows._Round``), bounded by the same timeout.

When every shard of a split lies on one card, the launches of all shards
still come from one thread at a time, and they bound the split (each
shard launches the whole network).  :meth:`ShardThreads.replay` then
captures a program of splits, every shard's launches and every halo
exchange, as one CUDA graph, and replays it: the shard threads enqueue
on the caller's stream, which is the capture stream during the capture,
so the graph's order is the turn order.
"""

from __future__ import annotations

import contextlib
import functools
import queue
import threading
import weakref
from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple)

import torch

from ..ops import rows
from ..ops.cuda.graphs import CapturedGraph, GraphPool
from ..ops.cuda.launch import capturing_counts, thread_counts
from ..ops.rows import RowExchange, Rounds, Shard

# Seconds a shard waits for its turn, or for another process's rows, before
# the run is given up (a build or a first cuDNN call of another shard may
# take a while).
TURN_TIMEOUT_S = 300.0


class RowSplitAborted(RuntimeError):
    """Raised in a shard whose turn came after another shard failed, or
    that waited longer than the timeout for its turn."""


class _Turns:
    """The ring of a run's shard threads, of which one runs at a time:
    thread ``k`` waits on its own lock, and the thread whose turn it is
    hands it on by releasing the next one's.  Only the thread holding the
    turn changes the ring."""

    def __init__(self, n: int):
        self._locks = [threading.Lock() for _ in range(n)]
        for lock in self._locks:
            lock.acquire()
        self._ring = list(range(n))
        self.holder = None
        self.failed = False

    def start(self) -> None:
        self._locks[0].release()

    def wait(self, k: int) -> None:
        if not self._locks[k].acquire(timeout=TURN_TIMEOUT_S):
            self.failed = True
            raise RowSplitAborted(f"row split: no turn for {TURN_TIMEOUT_S} s")
        self.holder = k
        if self.failed:
            raise RowSplitAborted("row split aborted: another shard failed")

    def pass_on(self, k: int, leave: bool = False) -> None:
        ring = self._ring
        nxt = ring[(ring.index(k) + 1) % len(ring)]
        if leave:
            ring.remove(k)
        self.holder = None
        if nxt != k or not leave:       # alone, a thread hands itself on
            self._locks[nxt].release()


class ShardThreads:
    """Long-lived threads for the shards of row splits: thread ``k`` runs
    job ``k`` of every :meth:`run`, so a caller that keeps one of these and
    hands it the same shards each time meets each device and shape in the
    same thread (the per-thread caches of the CUDA libraries stay warm).
    Threads start on first use and stop when this is closed or collected,
    or at exit.  Calls hold a lock, so threads may share one of these.
    ``graphs_captured`` counts the graphs of :meth:`replay` (one memory
    pool for all of them)."""

    def __init__(self):
        self._queues = []
        self._finalizer = weakref.finalize(self, _stop, self._queues)
        self._lock = threading.RLock()
        self._graphs: Dict[Any, CapturedGraph] = {}
        self._pool = GraphPool()

    @property
    def graphs_captured(self) -> int:
        return len(self._graphs)

    def replay(self, key, program: Callable[..., Tuple[Tuple[torch.Tensor,
                                                             ...], Any]],
               *inputs: torch.Tensor) -> Tuple[Tuple[torch.Tensor, ...], Any]:
        """``program(*inputs)``, which returns ``(outputs, meta)`` (a tuple
        of tensors and a host value) and runs its row splits through
        :meth:`run`, from a CUDA graph per ``key`` (the split's layout,
        batch, shapes and dtypes: whatever changes the launches).  All
        inputs and every shard lie on one card.

        The first call for a key runs the program eagerly, on the caller's
        stream, which warms each shard thread's libraries and builds the
        kernels, and returns that run's result; then it captures the
        program on static copies of the inputs (``ops.cuda.GraphPool``).
        Later calls copy the inputs into the static ones, replay the graph
        on the caller's stream (adding its launches to
        ``ops.cuda.LAUNCHES``) and return clones of its outputs with the
        meta of the capture.  A capture that fails raises."""
        with self._lock:
            graph = self._graphs.get(key)
            if graph is None:
                result = program(*inputs)
                self._graphs[key] = self._pool.capture(
                    inputs[0].device, program, *(x.clone() for x in inputs))
                return result
            outputs, meta = graph.replay(*inputs)
            return tuple(t.clone() for t in outputs), meta

    def run(self, splits: Sequence[Sequence[Optional[Tuple[
            torch.device, Callable[[], Any]]]]],
            lines: Optional[Sequence] = None
            ) -> Tuple[List[List[Any]], List[RowExchange]]:
        """Run every ``(device, work)`` shard of every split, each
        ``work()`` in a thread of its own, the threads taking turns; the
        shards of one split exchange halos with each other, in split order
        (shard 0 holds the frame's top rows).  A None shard runs in
        another process: ``lines[s]`` is then split ``s``'s
        ``parallel.transport.Line``, whose ranks run the other shards of
        the split at the same time (``lines`` None: every shard is
        here).  Each thread takes the
        caller's grad mode and, on CUDA, the device and the caller's
        current stream of that device, and the counts of the graph the
        caller captures.  Returns the results, shaped as ``splits`` (None
        at other processes' shards), and each split's exchange; raises the
        first error of any shard.  Under grad mode every exchange is an
        autograd node (``ops.rows``): a loss tied to the exchanges' last
        ``token`` (``ops.rows.tie``) runs the backward of every one."""
        with self._lock:
            return self._run(splits, lines)

    def _run(self, splits, lines):
        if not self._finalizer.alive:
            raise RuntimeError("ShardThreads.run after close()")
        grad = torch.is_grad_enabled()
        lines = list(lines) if lines else [None] * len(splits)
        exchanges = [RowExchange(len(split), line)
                     for split, line in zip(splits, lines)]
        run = Rounds(exchanges, TURN_TIMEOUT_S)
        results = [[None] * len(split) for split in splits]
        jobs = [(s, i, torch.device(shard[0]), shard[1])
                for s, split in enumerate(splits)
                for i, shard in enumerate(split) if shard is not None]
        if not jobs:
            return results, exchanges
        turns = _Turns(len(jobs))
        errors = []
        done = queue.SimpleQueue()
        counts = thread_counts()

        def shard_main(k, s, i, device, work, stream):
            rows.set_current(Shard(i, exchanges[s], turns, k, run, stream))
            try:
                turns.wait(k)
                with _on(device, stream), torch.set_grad_enabled(grad), (
                        capturing_counts(counts) if counts is not None
                        else contextlib.nullcontext()):
                    results[s][i] = work()
            except BaseException as e:       # re-raised by the caller below
                errors.append(e)
                turns.failed = True
            finally:
                rows.set_current(None)
                if turns.holder == k:
                    turns.pass_on(k, leave=True)
                done.put(k)

        while len(self._queues) < len(jobs):
            q = queue.SimpleQueue()
            thread = threading.Thread(target=_serve, args=(q,), daemon=True,
                                      name=f"row-shard-{len(self._queues)}")
            thread.start()
            self._queues.append((q, thread))
        for k, (s, i, device, work) in enumerate(jobs):
            stream = (torch.cuda.current_stream(device)
                      if device.type == "cuda" else None)
            self._queues[k][0].put(functools.partial(shard_main, k, s, i,
                                                  device, work, stream))
        turns.start()
        for _ in jobs:
            done.get()
        for ex in exchanges:
            ex.release()
        if errors:
            raise next((e for e in errors
                        if not isinstance(e, RowSplitAborted)), errors[0])
        return results, exchanges

    def close(self) -> None:
        self._finalizer()


HALO_KEYS = ("rounds", "gather_rounds", "bytes", "cross_rounds",
             "cross_bytes", "cross_seconds", "back_rounds",
             "back_cross_rounds", "back_cross_bytes", "back_cross_seconds")


def exchanged(exchanges: Sequence[RowExchange]) -> dict:
    """What the splits of one run exchanged per forward: ``rounds``
    exchanges, of which ``gather_rounds`` gathered the whole frame's rows
    and ``cross_rounds`` crossed processes, ``bytes``
    read from neighbouring shards over all splits, of which
    ``cross_bytes`` were received from other processes, and the host
    seconds of the cross-process steps (``cross_seconds``); the
    ``back_*`` of the same in the backward, once it has run (0 under no
    grad, read from each exchange's ``back``)."""
    return merge_halos([{k: getattr(e.back, k[5:]) if k.startswith("back_")
                         else getattr(e, k) for k in HALO_KEYS}
                        for e in exchanges])


def merge_halos(halos: Sequence[dict]) -> dict:
    """Several :func:`exchanged` records of splits run side by side as
    one: their rounds the most of any, their bytes and seconds summed."""
    return {k: (max if k.endswith("rounds") else sum)(h[k] for h in halos)
            for k in HALO_KEYS}


def _serve(jobs: queue.SimpleQueue) -> None:
    """A shard thread: runs the jobs it is handed until it gets None,
    holding none between jobs (a job reaches its run's tensors)."""
    for job in iter(jobs.get, None):
        job()
        del job


def _stop(queues: list) -> None:
    """Stop the threads and wait for them: a thread that has run CUDA or
    CPU work must end before the interpreter does, or its native state is
    torn down under it (the process aborts).  Also run at exit."""
    for q, _ in queues:
        q.put(None)
    for _, thread in queues:
        if thread is not threading.current_thread():
            thread.join()
    queues.clear()


def _on(device: torch.device, stream):
    """The thread's current CUDA device and stream, or nothing on the
    CPU."""
    if stream is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    stack.enter_context(torch.cuda.stream(stream))
    return stack
