"""The calling thread's row shard, and the halo exchange of the stereo
networks' row-mixing layers: the port's counterpart of the row sharding
that XLA's partitioner gives JAX's ``ShardedDnnEngine``
(``P(("data", "disp"), None, "tile", None)``).

Inside a row split (run by ``parallel.rows.ShardThreads``) each shard runs
the whole network on its own rows, in a thread of its own.  The functions
through which every row-mixing operation of GwcNet, MSNet2D and MSNet3D
passes consult the calling thread's shard (:func:`current`) and read the
rows they need across the shard's edges from the neighbouring shards:

* ``ops.conv3d.conv_same`` takes its SAME padding from the frame's height
  (:func:`frame_shape`), and the row pair of that padding from the
  neighbours (:func:`take_halo`): zeros at the frame's top and bottom, as
  SAME padding gives;
* ``ops.conv3d.deconv3d_parity`` and ``models.layers.deconv2d_parity`` take
  their one padded row on each side the same way;
* the bilinear and trilinear resizes (:func:`interpolate`) take one
  low-resolution row on each side, the edge row repeated at the frame's top
  and bottom, where the resize clamps its source index.

Deep3D's split (``models/deep3d.py``, under ``parallel.synthesis``) adds
its own funnels: the 3x3 convolutions (:func:`conv2d`) take their row pair
as ``conv_same`` does; the 2x2 max pool (:func:`max_pool2d`) needs an even
number of rows in each shard; where a shard's rows would stop pooling
whole, :func:`gather` joins every shard's rows on every shard, the levels
below run on the whole frame (:func:`unsplit`), and :func:`narrow` takes
the shard's rows of their outputs back; the blend's upsample takes one
volume row from each neighbour and none beyond the frame's edges
(:func:`neighbour_rows`), so that each output row reads what it reads in
the whole frame.

Everything else the networks do is row-local and runs on each shard
unchanged.  Outside a split these functions do what they always did.

Every shard reaches each exchange in the same order, since all run the same
code.  At an exchange (:func:`halo`) a shard publishes its tensor and hands
the turn to the next shard thread; when the turn comes back, every shard
has published, and it copies the rows it needs from its neighbours' (a peer
copy between cards, a plain read on one device).  Two slots alternate, so
a slot is written again only after every shard has read it.

A split whose shards lie on more than one process (a mesh over
``torch.distributed`` ranks) has the ``Line`` of its ranks
(``parallel.transport``), and each process runs only its own shards.
Once every local shard of a run has published at an exchange, the first
shard thread to get the turn back runs the exchange's cross-rank step
(:class:`Crossing`), for each split that spans ranks in split order: it
sends the rows that remote neighbours need (the last ``above`` rows to the
shard below, the first ``below`` rows to the shard above; every shard's
rows for :func:`gather`) with a digest of the exchange's key, and receives
the rows its own shards need into the slot, where they are read as a local
neighbour's are.  Every process runs the steps in one order (exchange,
then split), from one thread at a time, so two processes whose splits
share ranks wait on no step the other has not reached.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

_local = threading.local()


class RowExchange:
    """What the shards of one row split share: the two alternating slots
    of published tensors, the ``line`` of the split's ranks when its
    shards lie on more than one process (None when all are this
    process's), and what was exchanged: ``rounds`` exchanges, ``bytes``
    read from neighbours, and of those ``cross_rounds`` exchanges and
    ``cross_bytes`` received from other processes, which took
    ``cross_seconds`` on the host clock (waits for the other processes
    included)."""

    def __init__(self, count: int, line=None):
        self.count = count
        self.line = line
        self.rounds = 0
        self.bytes = 0
        self.cross_rounds = 0
        self.cross_bytes = 0
        self.cross_seconds = 0.0
        self._slots = [[None] * count, [None] * count]
        self.first = next((j for j in range(count) if self.local(j)), None)

    def local(self, j: int) -> bool:
        """Whether shard ``j`` runs in this process."""
        return self.line is None or self.line.local(j)


class Crossing:
    """The cross-rank steps of one run of row splits, over those of its
    splits' ``exchanges`` whose shards lie on more than one process.  Called
    with an exchange's round by the first thread to hold the turn after
    every local shard has published it; the later calls of that round do
    nothing.  ``timeout_s`` bounds each wait on another process."""

    def __init__(self, exchanges: Sequence[RowExchange], timeout_s: float):
        self.exchanges = [ex for ex in exchanges if ex.line is not None]
        self.timeout_s = timeout_s
        self.crossed = -1

    def __call__(self, r: int) -> None:
        if r <= self.crossed:
            return
        self.crossed = r
        for ex in self.exchanges:
            _cross(ex, r, self.timeout_s)


@dataclass
class Shard:
    """The calling thread's part of a row split: shard ``index`` of
    ``exchange.count`` (its index in the whole split, which may have
    shards in other processes), thread ``thread`` of the run's ``turns``
    (which has ``pass_on(thread)`` and ``wait(thread)``), on ``stream``
    (None on the CPU); ``crossing``, the run's :class:`Crossing` when a
    split of it spans processes."""

    index: int
    exchange: RowExchange
    turns: Any
    thread: int
    stream: Optional[Any] = None
    rounds: int = 0
    crossing: Optional[Crossing] = None

    @property
    def count(self) -> int:
        return self.exchange.count


def current() -> Optional[Shard]:
    """The calling thread's shard, or None outside a row split."""
    return getattr(_local, "shard", None)


def set_current(shard: Optional[Shard]) -> None:
    """Make ``shard`` the calling thread's (None: outside a split)."""
    _local.shard = shard


def frame_shape(x: torch.Tensor) -> List[int]:
    """The spatial sizes of ``x`` (N, C, [D,] H, W) in the whole frame: the
    shard's rows times the shard count inside a split."""
    sizes = list(x.shape[2:])
    shard = current()
    if shard is not None:
        sizes[-2] *= shard.count
    return sizes


def take_halo(x: torch.Tensor, pads: Sequence[Tuple[int, int]],
              stride: int = 1) -> Tuple[torch.Tensor, List[Tuple[int, int]]]:
    """``(x, pads)`` with the row pair of the SAME ``pads`` (one ``(low,
    high)`` per spatial axis) read from the neighbouring shards: inside a
    split, ``x`` gains ``low`` rows above and ``high`` below (zeros at the
    frame's edges) and the row pair becomes ``(0, 0)``.  A ``stride`` must
    divide the shard's rows, so that every shard starts on a row of the
    stride's grid.  Outside a split both come back unchanged."""
    pads = list(pads)
    if current() is None:
        return x, pads
    if x.shape[-2] % stride:
        raise ValueError(f"a shard of {x.shape[-2]} rows does not start on "
                         f"the grid of stride {stride}")
    x = halo(x, *pads[-2])
    pads[-2] = (0, 0)
    return x, pads


def interpolate(x: torch.Tensor, size: Sequence[int],
                mode: str) -> torch.Tensor:
    """``F.interpolate`` to ``size`` (half-pixel centres).  Inside a split
    the shard's rows are resized with one low-resolution row of each
    neighbour, the edge row repeated at the frame's top and bottom, then
    cropped to the shard's own rows; the rows must grow by a whole
    factor."""
    size = [int(s) for s in size]
    if current() is None:
        return F.interpolate(x, size=tuple(size), mode=mode,
                             align_corners=False)
    rows_in, rows_out = x.shape[-2], size[-2]
    if rows_out % rows_in:
        raise ValueError(f"a row split resizes rows by a whole factor, not "
                         f"{rows_in} -> {rows_out}")
    s = rows_out // rows_in
    size[-2] = rows_out + 2 * s
    y = F.interpolate(halo(x, 1, 1, edge="replicate"), size=tuple(size),
                      mode=mode, align_corners=False)
    return y.narrow(-2, s, rows_out)


def halo(x: torch.Tensor, above: int, below: int,
         edge: str = "zeros") -> torch.Tensor:
    """``x`` with ``above`` rows of the shard above and ``below`` rows of the
    shard below joined along its row axis (-2), inside a row split.  At
    the frame's top and bottom the rows are zeros (``edge="zeros"``), the
    edge row repeated (``"replicate"``) or none (``"none"``: the first
    and last shards gain rows on one side only).  Every shard of the
    split calls it at the same point."""
    key = (tuple(x.shape[:-2]), x.shape[-1], x.dtype, above, below, edge)
    shard, slot, key = _publish(x, key, (above, below))
    i = shard.index
    parts = [_neighbour(shard, slot, i - 1, above, key, x, edge, True), x,
             _neighbour(shard, slot, i + 1, below, key, x, edge, False)]
    return torch.cat(parts, dim=-2)


def neighbour_rows(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``(x with rows of its neighbours, rows joined above)``: inside a row
    split one row of each neighbouring shard, none beyond the frame's top
    or bottom; outside, ``(x, 0)``."""
    shard = current()
    if shard is None:
        return x, 0
    return halo(x, 1, 1, edge="none"), int(shard.index > 0)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.conv2d`` at stride 1 with SAME padding of an odd square kernel
    (``nn.Conv2d(k, padding=k // 2)``).  Inside a row split the padding
    rows above and below come from the neighbouring shards (zeros at the
    frame's edges), as :func:`take_halo` gives them; the columns are
    padded as outside."""
    p = weight.shape[-1] // 2
    if current() is None:
        return F.conv2d(x, weight, bias, padding=p)
    return F.conv2d(halo(x, p, p), weight, bias, padding=(0, p))


def max_pool2d(x: torch.Tensor) -> torch.Tensor:
    """``F.max_pool2d(x, 2)``: row-local when every shard holds an even
    number of rows, which a row split requires."""
    if current() is not None and x.shape[-2] % 2:
        raise ValueError(f"a shard of {x.shape[-2]} rows does not pool by "
                         f"2 whole: gather its rows first")
    return F.max_pool2d(x, 2)


def gather(x: torch.Tensor) -> torch.Tensor:
    """Inside a row split, the whole frame's rows of ``x``: every shard's
    ``x`` joined in shard order, on every shard (on ``x``'s device).
    Outside, ``x``.  Every shard of the split calls it at the same point;
    the shard then runs on the frame's rows under :func:`unsplit`."""
    if current() is None:
        return x
    shard, slot, key = _publish(x, (tuple(x.shape), x.dtype, "gather"),
                                None)
    parts = [x if j == shard.index else _fetch(shard, slot, j, key, x, None)
             for j in range(shard.count)]
    return torch.cat(parts, dim=-2)


def narrow(x: torch.Tensor) -> torch.Tensor:
    """Inside a row split, the calling shard's rows of ``x``, a tensor of
    the whole frame's rows (the output of layers run on :func:`gather`'s
    rows): shard ``i`` of ``n`` takes the ``i``-th n-th.  Outside, ``x``."""
    shard = current()
    if shard is None:
        return x
    if x.shape[-2] % shard.count:
        raise ValueError(f"{x.shape[-2]} frame rows do not split over "
                         f"{shard.count} shards")
    per = x.shape[-2] // shard.count
    return x.narrow(-2, shard.index * per, per)


@contextlib.contextmanager
def unsplit():
    """Inside the block the calling thread runs as outside its row split
    (the funnels see whole frames); its shard is back afterwards."""
    shard = current()
    set_current(None)
    try:
        yield
    finally:
        set_current(shard)


def _publish(x: torch.Tensor, key: tuple, rows: Optional[Tuple[int, int]]):
    """Publish ``x`` at the calling shard's next exchange and wait until
    every shard has: returns ``(shard, slot, key)``, the slot holding each
    shard's ``(tensor, stream, key, rows)`` and the exchange's key.
    ``rows``: the ``(above, below)`` rows a shard reads of its neighbours,
    None for all of every shard's."""
    shard = current()
    ex, i, r = shard.exchange, shard.index, shard.rounds
    key = key + (r,)
    slot = ex._slots[r % 2]
    shard.rounds += 1
    if i == ex.first:
        ex.rounds += 1
    slot[i] = (x, shard.stream, key, rows)
    shard.turns.pass_on(shard.thread)
    shard.turns.wait(shard.thread)
    if shard.crossing is not None:
        shard.crossing(r)
    return shard, slot, key


def _digest(key: tuple) -> int:
    """A digest of an exchange's key that every process computes alike."""
    return int.from_bytes(hashlib.blake2b(repr(key).encode(),
                                          digest_size=8).digest(),
                          "little", signed=True)


@contextlib.contextmanager
def _streams(entries):
    """The published entries' streams as their devices' current ones
    (transfers of a shard's tensor then follow the work that made it)."""
    with contextlib.ExitStack() as stack:
        for _, stream, _, _ in entries:
            if stream is not None:
                stack.enter_context(torch.cuda.stream(stream))
        yield


def _cross(ex: RowExchange, r: int, timeout_s: float) -> None:
    """Round ``r``'s cross-rank step of split ``ex``: each remote shard
    next to a local one gets, in the slot, the rows the local one reads
    (a dict of ``{True: its last rows, False: its first rows}``), or for
    a gather its whole tensor; the key of each is the local one when the
    remote digest agrees, else a key that :func:`_fetch` reports."""
    start = time.perf_counter()
    slot, line = ex._slots[r % 2], ex.line
    local = [j for j in range(ex.count) if ex.local(j)]
    x0, _, _, rows = slot[local[0]]
    # The digests go where the backend sends from: the host on gloo.
    home = "cpu" if line.transport.staging else x0.device
    digests = {j: torch.tensor([_digest(slot[j][2])], device=home)
               for j in local}

    def received(j, i, tensor, digest):
        """Count remote shard ``j``'s ``tensor``; the key under which local
        shard ``i`` reads it: ``i``'s own when ``j``'s ``digest`` agrees,
        else one that names the digest and its rank."""
        ex.cross_bytes += tensor.numel() * tensor.element_size()
        key = slot[i][2]
        if int(digest) != _digest(key):
            key = (f"digest {int(digest)} from rank {line.ranks[j]}",)
        return key

    with _streams([slot[j] for j in local]):
        if rows is None:
            whole = line.all_gather([slot[j][0] if j in digests else None
                                     for j in range(ex.count)], x0.device,
                                    timeout_s)
            keys = line.all_gather([digests.get(j)
                                    for j in range(ex.count)], home,
                                   timeout_s)
            for j in range(ex.count):
                if j not in digests:
                    slot[j] = (whole[j], None,
                               received(j, local[0], whole[j], keys[j]), rows)
        else:
            above, below = rows
            deepest = max(above, below)
            if x0.shape[-2] < deepest:
                raise ValueError(f"a halo of {deepest} rows is deeper than a "
                                 f"shard's {x0.shape[-2]} rows")
            wants = [(-1, lambda e: e[1]), (1, lambda e: e[1])]
            if above:
                wants.append((-1, lambda e: e[0].narrow(
                    -2, e[0].shape[-2] - above, above)))
            if below:
                wants.append((1, lambda e: e[0].narrow(-2, 0, below)))
            got = line.ring_fetch([(slot[j][0], digests[j])
                                   if j in digests else None
                                   for j in range(ex.count)],
                                  wants, wrap=False, timeout_s=timeout_s)
            for j in range(ex.count):
                if not ex.local(j):
                    slot[j] = ({}, None, None, rows)
            for i in local:
                for w, (offset, _) in enumerate(wants[2:], 2):
                    j = i + offset
                    if got[i][w] is None or ex.local(j):
                        continue
                    pieces = slot[j][0]
                    pieces[offset < 0] = got[i][w]
                    slot[j] = (pieces, None, received(
                        j, i, got[i][w], got[i][offset > 0]), rows)
    ex.cross_rounds += 1
    ex.cross_seconds += time.perf_counter() - start


def _edge(x: torch.Tensor, rows: int, top: bool, edge: str) -> torch.Tensor:
    """``rows`` rows beyond the frame's top or bottom edge of ``x``."""
    shape = list(x.shape)
    shape[-2] = rows
    if edge == "none":
        return x[..., :0, :]
    if edge == "zeros" or rows == 0:
        return x.new_zeros(shape)
    if edge != "replicate":
        raise ValueError(f"unknown edge rule {edge!r}")
    return x.narrow(-2, 0 if top else x.shape[-2] - 1, 1).expand(shape)


def _neighbour(shard: Shard, slot: list, j: int, rows: int, key, x, edge,
               above: bool) -> torch.Tensor:
    """The ``rows`` rows of shard ``j`` next to ``shard`` (its last rows
    when it lies above, its first below), on ``x``'s device; the frame's
    edge rows where there is no shard ``j``."""
    if not 0 <= j < shard.count:
        return _edge(x, rows, above, edge)
    if rows == 0:
        return x[..., :0, :]
    return _fetch(shard, slot, j, key, x, (rows, above))


def _fetch(shard: Shard, slot: list, j: int, key, x,
           part: Optional[Tuple[int, bool]]) -> torch.Tensor:
    """Shard ``j``'s published tensor, or its last (``part = (rows,
    True)``) or first (``(rows, False)``) rows, on ``x``'s device."""
    other, stream, other_key, _ = slot[j]
    if other_key != key:
        raise RuntimeError(f"row split out of step: shard {shard.index} "
                           f"exchanges {key}, shard {j} {other_key}")
    if isinstance(other, dict):         # rows received from another rank
        other = other[part[1]]
    elif part is not None:
        rows, above = part
        if other.shape[-2] < rows:
            raise ValueError(f"a halo of {rows} rows is deeper than shard "
                             f"{j}'s {other.shape[-2]} rows")
        other = other.narrow(-2, other.shape[-2] - rows if above else 0,
                             rows)
    shard.exchange.bytes += other.numel() * other.element_size()
    if other.device == x.device:
        return other
    # A peer copy runs on the source device's current stream: make that the
    # stream the neighbour computed on, so it follows the neighbour's work.
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        return other.to(x.device)
