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

Every wait of a run is bounded.  A shard waits at most ``TURN_TIMEOUT_S``
for its turn, and the caller of :meth:`ShardThreads.run` gives the run up
once a shard has held the turn that long without reaching its next
exchange (its cross-rank steps carry their own bounds): the run raises an
error naming the stuck shard, the others raise at once, and the stuck
thread is retired (it ends when its job returns; nothing waits for it,
and as a daemon it does not keep its process alive).
:meth:`ShardThreads.close` waits at most ``TURN_TIMEOUT_S`` for its
threads.

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
import time
import weakref
from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple)

import torch

from ..ops import rows
from ..ops.cuda.graphs import CapturedGraph, GraphPool
from ..ops.cuda.launch import capturing_counts, thread_counts
from ..ops.rows import RowExchange, Rounds, Shard

# Seconds a shard waits for its turn, or for another process's rows, or
# holds its turn between two exchanges, before the run is given up (a
# build or a first cuDNN call of another shard may take a while); also how
# long ShardThreads.close waits for its threads.
TURN_TIMEOUT_S = 300.0


class RowSplitAborted(RuntimeError):
    """Raised in a shard whose turn came after another shard failed, or
    that waited longer than the timeout for its turn, and by
    :meth:`ShardThreads.run` for a shard that held its turn longer than
    the timeout."""


class _Turns:
    """The ring of a run's shard threads, of which one runs at a time:
    thread ``k`` waits on its own condition until the turn is its own, and
    the thread whose turn it is hands it on to the next.  Only the thread
    holding the turn changes the ring.  ``since`` is when the turn last
    moved, None while its holder is in a step whose waits carry their own
    bounds (:meth:`bounded`)."""

    def __init__(self, n: int):
        self._lock = threading.Lock()
        self._ready = [threading.Condition(self._lock) for _ in range(n)]
        self._ring = list(range(n))
        self.turn = None
        self.holder = None
        self.since = None
        self.failed = False

    def start(self) -> None:
        self._hand(0)

    def _hand(self, k: int) -> None:
        with self._lock:
            self.turn = k
            self.since = time.monotonic()
            self._ready[k].notify()

    def wait(self, k: int) -> None:
        with self._lock:
            if not self._ready[k].wait_for(
                    lambda: self.turn == k or self.failed, TURN_TIMEOUT_S):
                self._abort()
                raise RowSplitAborted(
                    f"row split: shard thread {k} got no turn for "
                    f"{TURN_TIMEOUT_S} s")
            if self.failed:
                raise RowSplitAborted("row split aborted: another shard failed")
            self.holder = k

    def pass_on(self, k: int, leave: bool = False) -> None:
        ring = self._ring
        nxt = ring[(ring.index(k) + 1) % len(ring)]
        if leave:
            ring.remove(k)
        self.holder = None
        if nxt != k or not leave:       # alone, a thread hands itself on
            self._hand(nxt)

    def abort(self) -> None:
        """Mark the run failed: every thread waiting for its turn raises."""
        with self._lock:
            self._abort()

    def _abort(self) -> None:
        self.failed = True
        for ready in self._ready:
            ready.notify()

    @contextlib.contextmanager
    def bounded(self):
        """A step of the holder whose every wait has a bound of its own (a
        round's cross-rank messages): the caller's watch does not count
        it as holding the turn."""
        self.since = None
        try:
            yield
        finally:
            self.since = time.monotonic()

    def stalled(self) -> Optional[float]:
        """Seconds the turn has stayed with its holder outside a bounded
        step, None inside one."""
        since = self.since
        return None if since is None else time.monotonic() - since


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
        self._guard = threading.Lock()      # over _queues
        self._finalizer = weakref.finalize(self, _stop, self._queues,
                                           self._guard)
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
                turns.abort()
            finally:
                rows.set_current(None)
                if turns.holder == k:
                    turns.pass_on(k, leave=True)
                done.put(k)

        with self._guard:
            while len(self._queues) < len(jobs):
                self._queues.append(_start(len(self._queues)))
        for k, (s, i, device, work) in enumerate(jobs):
            stream = (torch.cuda.current_stream(device)
                      if device.type == "cuda" else None)
            self._queues[k][0].put(functools.partial(shard_main, k, s, i,
                                                  device, work, stream))
        turns.start()
        stuck = self._watch(turns, done, jobs)
        for ex in exchanges:
            ex.release()
        if errors or stuck:
            raise next((e for e in errors
                        if not isinstance(e, RowSplitAborted)),
                       stuck or errors[0])
        return results, exchanges

    def _watch(self, turns: _Turns, done: queue.SimpleQueue,
               jobs: list) -> Optional[RowSplitAborted]:
        """Wait until every job of the run has reported on ``done``, or
        until a shard has held the turn ``TURN_TIMEOUT_S`` outside a
        bounded step: the run is then marked failed (the shards waiting
        for their turn raise at once) and the error naming the stuck
        shard is returned.  A thread that has not reported by then, or
        within another ``TURN_TIMEOUT_S`` for the others, is retired: it
        ends when its job returns, and a new thread takes its place."""
        pending, stuck, deadline = set(range(len(jobs))), None, None
        while pending:
            if deadline is None:
                left = TURN_TIMEOUT_S - (turns.stalled() or 0.0)
            else:
                left = deadline - time.monotonic()
            try:
                pending.discard(done.get(timeout=max(left, 0.0)))
                continue
            except queue.Empty:
                pass
            if deadline is not None:
                break
            stalled = turns.stalled()
            if stalled is None or stalled < TURN_TIMEOUT_S:
                continue
            k = turns.turn
            s, i, device, _ = jobs[k]
            stuck = RowSplitAborted(
                f"row split: shard {i} of split {s} (on {device}, thread "
                f"{_name(k)}) held its turn for more than {TURN_TIMEOUT_S} s "
                f"without reaching its next exchange")
            turns.abort()
            pending.discard(k)
            self._retire(k)
            deadline = time.monotonic() + TURN_TIMEOUT_S
        for k in pending:
            self._retire(k)
        return stuck

    def _retire(self, k: int) -> None:
        """Replace thread ``k``, which is still in a job, with a new one
        (none once closed, which has stopped it); it ends when that job
        returns."""
        with self._guard:
            if self._finalizer.alive:
                self._queues[k][0].put(None)
                self._queues[k] = _start(k)

    def close(self) -> None:
        """Stop the threads, waiting at most ``TURN_TIMEOUT_S`` for them;
        raises ``RuntimeError`` naming a thread that is still in a job
        then (it is left to end on its own: a daemon)."""
        left = self._finalizer()
        if left:
            raise RuntimeError(f"ShardThreads.close: {', '.join(left)} still "
                               f"in a job after {TURN_TIMEOUT_S} s")


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


def _start(k: int) -> Tuple[queue.SimpleQueue, threading.Thread]:
    """Shard thread ``k``, started, and the queue of its jobs."""
    q = queue.SimpleQueue()
    thread = threading.Thread(target=_serve, args=(q,), daemon=True,
                              name=_name(k))
    thread.start()
    return q, thread


def _name(k: int) -> str:
    return f"row-shard-{k}"


def _stop(queues: list, guard: threading.Lock) -> List[str]:
    """Stop the threads and wait for them, at most ``TURN_TIMEOUT_S`` in
    all: a thread that has run CUDA or CPU work must end before the
    interpreter does, or its native state is torn down under it (the
    process aborts).  Also run at exit.  Returns the names of the threads
    still running then (each a daemon, which does not hold the process
    at exit)."""
    with guard:
        stopping = list(queues)
        queues.clear()
    for q, _ in stopping:
        q.put(None)
    deadline = time.monotonic() + TURN_TIMEOUT_S
    left = []
    for _, thread in stopping:
        if thread is not threading.current_thread():
            thread.join(max(deadline - time.monotonic(), 0.0))
            if thread.is_alive():
                left.append(thread.name)
    return left


def _on(device: torch.device, stream):
    """The thread's current CUDA device and stream, or nothing on the
    CPU."""
    if stream is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    stack.enter_context(torch.cuda.stream(stream))
    return stack
