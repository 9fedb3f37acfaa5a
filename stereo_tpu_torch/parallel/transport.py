"""Moving shard values between the processes of a mesh over
``torch.distributed`` (the cross-host collectives of JAX's mesh once
``jax.distributed`` is up).

A mesh built under a process group of more than one rank
(``parallel.mesh.make_mesh``) records the rank of each entry; every rank
runs the same engine call on the same global batch and holds values for
its own entries only.  The collectives of ``parallel/classical.py`` take
the list of one ring or one disp group with ``None`` at the entries of
other ranks and hand the cross-process part to a :class:`Line` of that
list:

* ``ring_fetch`` — each local entry receives a piece of its ring
  neighbours' values: point to point (``batch_isend_irecv``) where the
  neighbour is remote, ``.to()`` where it is local; with ``wrap=False``
  the line is a row split's column of shards, whose first and last
  entries have no neighbour past the frame's edges;
* ``all_reduce`` — a reduction over the ranks of the line, after the
  caller reduced its local entries;
* ``all_gather`` — every entry's value in entry order.

:meth:`Transport.all_gather_parts` delivers parts of a result to every
rank of the group.  Sub-groups are made once per set of ranks, at engine
construction, in the same order on every rank (``Transport.group``).

NCCL moves CUDA tensors directly.  gloo moves only host tensors point to
point, so where the backend is gloo a CUDA tensor is copied to the host
and back explicitly, and :attr:`Transport.staged_bytes` counts the bytes
of those copies; the computation stays on the card.

:func:`spawn_ranks` starts a group of local processes on a file store and
joins them within a time limit: the multi-process tests and the card's
smoke phase run through it.
"""

from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# Seconds any wait of the transport lasts at most before it raises: each
# message and collective it waits on, and the groups it makes (and the
# default group of ``parallel.initialize_distributed``), whose own timeout
# bounds the collectives that take none (``new_group``,
# ``all_gather_object``, ``barrier``).  PyTorch's default is 30 minutes.
TIMEOUT_S = 300.0


def timeout() -> datetime.timedelta:
    """:data:`TIMEOUT_S` as a process group takes it."""
    return datetime.timedelta(seconds=TIMEOUT_S)


def world_size() -> int:
    """The default process group's size, 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class Transport:
    """This process's end of the mesh's exchanges: its rank, the group's
    backend, the sub-groups made so far and the bytes staged through the
    host."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.staging = dist.get_backend() == "gloo"
        self.staged_bytes = 0
        self._groups = {}

    def group(self, ranks: Sequence[int]):
        """The process group of ``ranks`` (the default group for all of
        them), made on first use.  Every rank must ask for the same groups
        in the same order, members or not, as ``dist.new_group``
        requires."""
        ranks = tuple(sorted(set(ranks)))
        if len(ranks) == dist.get_world_size():
            return dist.group.WORLD
        if ranks not in self._groups:
            self._groups[ranks] = dist.new_group(list(ranks),
                                                 timeout=timeout())
        return self._groups[ranks]

    # -- host staging (gloo) ----------------------------------------------

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend sends it."""
        t = t.contiguous()
        if self.staging and t.is_cuda:
            self.staged_bytes += t.numel() * t.element_size()
            return t.cpu()
        return t

    def _buffer(self, like: torch.Tensor) -> torch.Tensor:
        """A receive buffer for a tensor like ``like``."""
        if self.staging and like.is_cuda:
            return torch.empty(like.shape, dtype=like.dtype)
        return torch.empty_like(like, memory_format=torch.contiguous_format)

    def _back(self, t: torch.Tensor, device) -> torch.Tensor:
        """A received ``t`` on ``device``."""
        if t.device.type != torch.device(device).type:
            self.staged_bytes += t.numel() * t.element_size()
        return t.to(device)

    # -- collectives --------------------------------------------------------

    def all_reduce(self, t: torch.Tensor, op, group) -> torch.Tensor:
        """``t`` reduced by ``op`` over ``group``, on ``t``'s device."""
        buf = self._out(t)
        if buf is t:
            buf = t.clone()
        _wait(dist.all_reduce(buf, op, group=group, async_op=True), None,
              f"rank {self.rank}: all_reduce over ranks "
              f"{dist.get_process_group_ranks(group)}")
        return self._back(buf, t.device)

    def all_gather_parts(self, parts: Sequence[Optional[torch.Tensor]],
                         owners: Sequence[int], device, group=None,
                         like: Optional[torch.Tensor] = None,
                         timeout_s: Optional[float] = None
                         ) -> List[torch.Tensor]:
        """Every part of ``parts`` on ``device``.  ``owners[i]`` is the rank
        holding part i; ``parts[i]`` is that tensor on its owner and None
        elsewhere.  All parts have one shape and dtype: ``like``'s where
        the caller has a tensor of them, else learnt from the ranks that
        hold a part (one more collective; a rank may hold none).  Called
        by every rank of ``group`` (default: all); ``timeout_s`` as in
        :meth:`Line.ring_fetch`."""
        members = dist.get_process_group_ranks(group or dist.group.WORLD)
        mine = [p for p, o in zip(parts, owners) if o == self.rank]
        if like is not None:
            shape, dtype = tuple(like.shape), like.dtype
        else:
            meta = [None] * len(members)
            dist.all_gather_object(
                meta, (tuple(mine[0].shape), mine[0].dtype) if mine else None,
                group=group)
            shape, dtype = next(m for m in meta if m is not None)
        numel = math.prod(shape)
        slots = max(list(owners).count(r) for r in members)
        flat = torch.zeros(slots * numel, dtype=dtype, device=device)
        if mine:
            flat[:len(mine) * numel] = torch.cat(
                [p.reshape(-1).to(device) for p in mine])
        sent = self._out(flat)
        bufs = [torch.empty_like(sent) for _ in members]
        _wait(dist.all_gather(bufs, sent, group=group, async_op=True),
              timeout_s, f"rank {self.rank}: all_gather over ranks {members}")
        bufs = [self._back(b, device) for b in bufs]
        out, seen = [], {}
        for o in owners:
            k = seen.get(o, 0)
            seen[o] = k + 1
            out.append(bufs[members.index(o)][k * numel:(k + 1) * numel]
                       .view(shape))
        return out


class Line:
    """One ring (``tile``) or disp group of a mesh whose entries lie on
    more than one process: ``ranks[i]`` is the rank of entry i."""

    def __init__(self, transport: Transport, ranks: Sequence[int]):
        self.transport = transport
        self.ranks = list(ranks)
        self.group = transport.group(self.ranks)

    def local(self, i: int) -> bool:
        return self.ranks[i] == self.transport.rank

    def ring_fetch(self, xs: Sequence[Optional[object]],
                   wants: Sequence[tuple], wrap: bool = True,
                   timeout_s: Optional[float] = None) -> list:
        """For each local entry i and each ``(offset, piece)`` of
        ``wants``: ``piece(xs[(i + offset) % n])`` on the device of
        ``piece(xs[i])``; None rows at remote entries.  Without ``wrap``
        there is no entry past either end: a want whose ``i + offset``
        lies outside ``0..n-1`` stays None and posts no message.  Every
        value of the line has one shape, so a received piece has the
        shape of ``piece(xs[i])``.  Messages are posted in one global
        order (receiver, then want), so both ends of a pair post theirs
        in the same order; each carries its own tag.  ``timeout_s`` bounds
        the wait for each message (None: :data:`TIMEOUT_S`); on gloo a
        message that times out raises ``RuntimeError``, naming the ranks
        it waited for."""
        tr, n = self.transport, len(xs)
        out = [[None] * len(wants) if self.local(i) else None
               for i in range(n)]
        ops, pending = [], []
        for i in range(n):
            for w, (offset, piece) in enumerate(wants):
                j = i + offset
                if wrap:
                    j %= n
                elif not 0 <= j < n:
                    continue
                tag = i * len(wants) + w
                if self.local(i) and self.local(j):
                    out[i][w] = piece(xs[j]).to(piece(xs[i]).device)
                elif self.local(j):
                    ops.append(dist.P2POp(dist.isend, tr._out(piece(xs[j])),
                                          self.ranks[i], self.group, tag))
                elif self.local(i):
                    mine = piece(xs[i])
                    buf = tr._buffer(mine)
                    ops.append(dist.P2POp(dist.irecv, buf, self.ranks[j],
                                          self.group, tag))
                    pending.append((i, w, buf, mine.device))
        if ops:
            peers = sorted({op.peer for op in ops})
            for work in dist.batch_isend_irecv(ops):
                _wait(work, timeout_s, f"rank {tr.rank}: ring_fetch over "
                      f"ranks {self.ranks}, messages with ranks {peers}")
        for i, w, buf, device in pending:
            out[i][w] = tr._back(buf, device)
        return out

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        """``t`` (this rank's entries already reduced) reduced over the
        line's ranks."""
        return self.transport.all_reduce(t, op, self.group)

    def all_gather(self, xs: Sequence[Optional[torch.Tensor]], device,
                   timeout_s: Optional[float] = None) -> List[torch.Tensor]:
        """Every entry's value (one shape for all) in entry order, on
        ``device``.  Every rank of the line holds an entry, so the shape
        and dtype come from a local one."""
        return self.transport.all_gather_parts(
            xs, self.ranks, device, self.group,
            like=next(x for x in xs if x is not None), timeout_s=timeout_s)


def _wait(work, timeout_s: Optional[float], what: str) -> None:
    """Wait for ``work`` at most ``timeout_s`` seconds (None:
    :data:`TIMEOUT_S`); a wait that fails raises ``RuntimeError`` naming
    ``what`` it waited for."""
    seconds = TIMEOUT_S if timeout_s is None else timeout_s
    try:
        work.wait(datetime.timedelta(seconds=seconds))
    except RuntimeError as exc:
        raise RuntimeError(f"{what} (bound {seconds} s): {exc}") from exc


def spawn_ranks(target: Callable, world: int, store: str, args=(),
                timeout_s: float = 300.0) -> List[int]:
    """Run ``target(rank, world, init_method, *args)`` in ``world`` local
    processes (``multiprocessing``'s spawn context: CUDA and threads of
    the caller stay its own) on the file store ``store``, which must not
    exist yet.  Waits at most ``timeout_s`` in all, and no longer once a
    process has failed (a rank that raised leaves the others blocked in a
    collective): the processes still running then are terminated.
    Returns the exit codes, None for a process that was terminated."""
    ctx = multiprocessing.get_context("spawn")
    init = "file://" + os.path.abspath(store)
    procs = [ctx.Process(target=target, args=(rank, world, init, *args))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and any(p.is_alive() for p in procs):
        if any(p.exitcode not in (None, 0) for p in procs):
            break       # the others would wait on it in a collective
        time.sleep(0.05)
    codes = []
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes
