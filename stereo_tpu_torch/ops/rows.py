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
* the bilinear and trilinear resizes (:func:`interpolate`, and Deep3D's
  training upsample :func:`upsample_bilinear`) take one low-resolution row
  on each side, the edge row repeated at the frame's top and bottom, where
  the resize clamps its source index.

Deep3D's split (``models/deep3d.py``, under ``parallel.synthesis`` and
``parallel.train``; a shard of any whole number of rows, one included)
adds its own funnels: the 3x3 convolutions (:func:`conv2d`) take their
row pair as ``conv_same`` does; the 2x2 max pool (:func:`max_pool2d`)
needs an even number of rows in each shard; where a shard's rows would
stop pooling whole, :func:`gather` joins every shard's rows on every
shard, the levels below run on the whole frame (:func:`unsplit`), and
:func:`narrow` takes the shard's rows back at the first output whose rows
divide over the shards (the branch predictions at down/2, or the softmax
volume at the down rows when a shard's down rows are odd); the blend's
upsample takes one volume row from each neighbour and none beyond the
frame's edges (:func:`neighbour_rows`), so that each output row reads
what it reads in the whole frame.

GwcNet's and MSNet's split (``models/gwcnet.py``, ``models/msnet.py``,
under ``parallel.dnn``; a shard of any whole number of rows) gathers the
same way ahead of a stride-2 layer whose input rows a shard cannot halve,
or would halve to fewer rows than the halo of the level below it
(:class:`Descent`), and narrows back where a skip of the shard's rows
meets the gathered levels' output, or at the disparities.

Everything else the networks do is row-local and runs on each shard
unchanged.  Outside a split these functions do what they always did.

Every shard reaches each exchange in the same order, since all run the same
code.  At an exchange (:func:`halo`) a shard publishes its tensor and hands
the turn to the next shard thread.  The first thread whose turn comes back
finds every shard published and runs the exchange's round for every split
of the run (:class:`Rounds`): it copies the rows each shard reads of its
neighbours' (a peer copy between cards, a plain read on one device) and
joins them to the shard's own.  Two slots alternate, so a slot is written
again only after every shard has read it.

A split whose shards lie on more than one process (a mesh over
``torch.distributed`` ranks) has the ``Line`` of its ranks
(``parallel.transport``), and each process runs only its own shards.  Its
round first runs the exchange's cross-rank step, for each split that
spans ranks in split order: it sends the rows that remote neighbours need
(the last ``above`` rows to the shard below, the first ``below`` rows to
the shard above; every shard's rows for :func:`gather`) with a digest of
the exchange's key, and receives the rows its own shards need into the
slot, where they are read as a local neighbour's are.  Every process runs
the steps in one order (exchange, then split), from one thread at a time,
so two processes whose splits share ranks wait on no step the other has
not reached.

Under grad mode (a training step) each round is one autograd node
(:class:`_Round`): its inputs are this process's published tensors, its
outputs every local shard's joined rows, and its forward the round.  Its
backward carries each joined row's gradient back to the shard it was
read from, across ranks through the split's ``Line`` (the halo's edge
rows with the offsets reversed; for :func:`gather` each reader's
gradient of every shard's rows), and sums a shard's terms in one fixed
order (its own rows, the frame's edge, the reader above, the reader
below; a gather's readers in shard order), so a split gives the same
bits whichever process holds each shard.  The nodes of a run form a
chain through a token (each takes the previous round's), so backward
runs the rounds in reverse on every rank; :func:`tie` hangs the last
token on a loss, so every round's backward runs, sending zeros where
its rows got no gradient.  Each backward wait is bounded by the run's
timeout, and the round's key digest travels with the gradients: an
exchange out of step raises on both ranks.

A node keeps only what its backward reads (:class:`_Side`, one per split:
the shard count, the ``Line``, each shard's spec, key digest and rows,
and the counts its backward adds to), never the run's exchanges: an
exchange holds the run's last token, whose node reaches every earlier
round's, and a node that held the exchanges would close a cycle through
the autograd graph, which Python's collector cannot see.  So a run is
freed once its outputs are, whether or not its backward ever runs (a loss
computed for evaluation, an error between forward and backward).
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
    process's), and what was exchanged: ``rounds`` exchanges, of which
    ``gather_rounds`` gathered the whole frame's rows (:func:`gather`),
    ``bytes`` read from neighbours, and of those ``cross_rounds``
    exchanges and ``cross_bytes`` received from other processes, which
    took ``cross_seconds`` on the host clock (waits for the other
    processes included).  ``back`` holds the same of the backward
    (:class:`_Round`), which adds to it when it runs; ``token`` is the
    run's last round's token under grad mode (for :func:`tie`)."""

    def __init__(self, count: int, line=None):
        self.count = count
        self.line = line
        self.rounds = 0
        self.gather_rounds = 0
        self.bytes = 0
        self.cross_rounds = 0
        self.cross_bytes = 0
        self.cross_seconds = 0.0
        self.back = BackCounts()
        self.token = None
        self._slots = [[None] * count, [None] * count]
        self._outs = [[None] * count, [None] * count]
        self.first = next((j for j in range(count) if self.local(j)), None)

    def local(self, j: int) -> bool:
        """Whether shard ``j`` runs in this process."""
        return self.line is None or self.line.local(j)

    def release(self) -> None:
        """Drop the slots' tensors once the run has ended (they would
        otherwise live as long as the exchange)."""
        self._slots = [[None] * self.count, [None] * self.count]
        self._outs = [[None] * self.count, [None] * self.count]


@dataclass
class BackCounts:
    """What the backward of a split's rounds exchanged (``RowExchange.back``,
    read as the ``back_*`` of ``parallel.rows.exchanged``), added to by
    each round's backward."""

    rounds: int = 0
    cross_rounds: int = 0
    cross_bytes: int = 0
    cross_seconds: float = 0.0


class Rounds:
    """The once-a-round step of one run of row splits (``exchanges``, in
    split order): called with an exchange's round by the first thread to
    hold the turn after every local shard has published it (the later
    calls of that round do nothing), it joins every local shard's rows
    (:func:`_exchange`), as a :class:`_Round` node under grad mode.
    ``timeout_s`` bounds each wait on another process, in the backward
    too."""

    def __init__(self, exchanges: Sequence[RowExchange], timeout_s: float):
        self.exchanges = list(exchanges)
        self.timeout_s = timeout_s
        self.done = -1
        self.token = None

    def __call__(self, r: int) -> None:
        if r <= self.done:
            return
        self.done = r
        plan = _Plan(self, r)
        xs = [self.exchanges[k]._slots[r % 2][j][0] for k, j in plan.keys]
        if torch.is_grad_enabled():
            if self.token is None:
                # A leaf that requires grad: every round is a node, the
                # first (whose inputs are images) too, so every rank's
                # backward crosses each round.
                self.token = torch.zeros((), device=xs[0].device,
                                         requires_grad=True)
            self.token, *outs = _Round.apply(plan, self.token, *xs)
            for ex in self.exchanges:
                ex.token = self.token
        else:
            outs = _exchange(plan)
        for (k, j), out in zip(plan.keys, outs):
            self.exchanges[k]._outs[r % 2][j] = out


class _Side:
    """What the backward of round ``r`` reads of one split, which runs on
    autograd's thread, outside the split: its shard ``count``, ``line``,
    the wait's ``timeout_s``, the counts it adds to (``back``), and
    (filled in by :func:`_exchange`) each local shard's spec, key digest,
    rows and joined rows above (``meta``).  It holds no
    :class:`RowExchange` (see the module's docstring)."""

    def __init__(self, ex: RowExchange, r: int, timeout_s: float):
        self.count = ex.count
        self.line = ex.line
        self.back = ex.back
        self.r = r
        self.timeout_s = timeout_s
        self.meta = {}

    def local(self, j: int) -> bool:
        return self.line is None or self.line.local(j)


class _Plan:
    """One round of a run: its exchanges, the round, the ``(split,
    shard)`` of each local shard (``keys``, the split by its index in
    ``exchanges``) and each split's :class:`_Side`, of which a
    :class:`_Round` node keeps the ``sides`` and ``keys``."""

    def __init__(self, rounds: Rounds, r: int):
        self.exchanges = rounds.exchanges
        self.r = r
        self.keys = [(k, j) for k, ex in enumerate(self.exchanges)
                     for j in range(ex.count) if ex.local(j)]
        self.sides = [_Side(ex, r, rounds.timeout_s)
                      for ex in self.exchanges]


def _exchange(plan: _Plan) -> List[torch.Tensor]:
    """Round ``plan.r`` of every split in split order: the cross-rank step
    of a split whose shards lie on several processes, then each local
    shard's joined rows (:func:`halo`'s or :func:`gather`'s), in the order
    of ``plan.keys``."""
    r, joined = plan.r, {}
    for k, (ex, side) in enumerate(zip(plan.exchanges, plan.sides)):
        slot = ex._slots[r % 2]
        local = [j for j in range(ex.count) if ex.local(j)]
        if ex.line is not None:
            _cross(ex, r, side.timeout_s)
        with _streams([slot[j] for j in local]):
            for j in local:
                x, _, key, spec = slot[j]
                parts = (_gathered(ex, slot, j) if spec is None
                         else _halo_parts(ex, slot, j))
                side.meta[j] = (spec, _digest(key), x.shape[-2],
                                parts[0].shape[-2] if spec else 0)
                joined[k, j] = torch.cat(parts, dim=-2)
    return [joined[key] for key in plan.keys]


class _Round(torch.autograd.Function):
    """One exchange of every split of a run under grad mode: inputs, this
    process's published tensors; outputs, the next token and each local
    shard's joined rows (:func:`halo`'s or :func:`gather`'s)."""

    @staticmethod
    def forward(ctx, plan: _Plan, token, *xs):
        # Only the sides and keys: never the exchanges (module docstring).
        ctx.sides, ctx.keys = plan.sides, plan.keys
        return (torch.zeros((), device=xs[0].device), *_exchange(plan))

    @staticmethod
    def backward(ctx, _, *douts):
        keys = ctx.keys
        wanted = dict(zip(keys, ctx.needs_input_grad[2:]))
        grads = {}
        for k, side in enumerate(ctx.sides):
            d = {j: g for (s, j), g in zip(keys, douts) if s == k}
            if not d:
                continue
            grads.update(((k, j), g) for j, g in _carry_back(
                side, d, {j: wanted[k, j] for j in d}).items())
        return (None, None, *(grads[key] for key in keys))


def tie(x: torch.Tensor, token: Optional[torch.Tensor]) -> torch.Tensor:
    """``x``, whose backward also runs the backward of the run whose last
    token is ``token`` (``RowExchange.token``) to its first round, each
    round sending zeros where its rows got no gradient.  ``token`` None:
    ``x`` unchanged."""
    return x if token is None else _Tie.apply(x, token)


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, token):
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


@dataclass
class Shard:
    """The calling thread's part of a row split: shard ``index`` of
    ``exchange.count`` (its index in the whole split, which may have
    shards in other processes), thread ``thread`` of the run's ``turns``
    (which has ``pass_on(thread)``, ``wait(thread)`` and ``bounded()``,
    the context of a step whose waits carry their own bounds), whose
    rounds ``run`` steps, on ``stream`` (None on the CPU)."""

    index: int
    exchange: RowExchange
    turns: Any
    thread: int
    run: Rounds
    stream: Optional[Any] = None
    rounds: int = 0

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


def upsample_bilinear(x: torch.Tensor, s: int) -> torch.Tensor:
    """``F.interpolate(x, scale_factor=s, mode="bilinear")`` (half-pixel
    centres, the edge rows and columns repeated) for a whole factor ``s``,
    written as shifted slices and weighted sums: its backward adds each
    input's few contributions in a fixed order, where ``F.interpolate``'s
    adds them with atomics on CUDA (which
    ``torch.use_deterministic_algorithms`` refuses), so a training step
    gives the same bits run after run.  The rows first: inside a row split
    the row above and below come from the neighbouring shards (the edge
    row repeated at the frame's top and bottom), so each shard's output
    rows are the whole frame's.  At the frame's top the two weights of the
    repeated row are summed in float, where ``F.interpolate`` reads the
    row once: a rounding apart."""
    if current() is None:
        x = torch.cat([x[..., :1, :], x, x[..., -1:, :]], dim=-2)
    else:
        x = halo(x, 1, 1, edge="replicate")
    x = _upsample_along(x, s, -2)
    return _upsample_along(torch.cat([x[..., :1], x, x[..., -1:]], dim=-1),
                           s, -1)


def _upsample_along(padded: torch.Tensor, s: int, axis: int) -> torch.Tensor:
    """The x ``s`` linear upsample along ``axis`` (-2 or -1) of ``padded``,
    which holds one more entry at each end: output ``s*i + r`` sits at
    ``i + f``, ``f = (r + 1/2) / s - 1/2``, between entries ``i - 1`` and
    ``i`` (``f < 0``) or ``i`` and ``i + 1``."""
    n = padded.shape[axis] - 2
    prev, mid, nxt = (padded.narrow(axis, k, n) for k in range(3))
    phases = []
    for r in range(s):
        f = (r + 0.5) / s - 0.5
        phases.append((-f) * prev + (1 + f) * mid if f < 0
                      else (1 - f) * mid + f * nxt)
    return torch.stack(phases, dim=axis).flatten(axis - 1, axis)


def halo(x: torch.Tensor, above: int, below: int,
         edge: str = "zeros") -> torch.Tensor:
    """``x`` with ``above`` rows of the shard above and ``below`` rows of the
    shard below joined along its row axis (-2), inside a row split.  At
    the frame's top and bottom the rows are zeros (``edge="zeros"``), the
    edge row repeated (``"replicate"``) or none (``"none"``: the first
    and last shards gain rows on one side only).  Every shard of the
    split calls it at the same point."""
    key = (tuple(x.shape[:-2]), x.shape[-1], x.dtype, above, below, edge)
    return _publish(x, key, (above, below, edge))


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
    number of rows, which a row split requires (gather a shard of odd rows
    first, :func:`gather`)."""
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
    return _publish(x, (tuple(x.shape), x.dtype, "gather"), None)


def narrow(x: torch.Tensor) -> torch.Tensor:
    """Inside a row split, the calling shard's rows of ``x``, a tensor of
    the whole frame's rows (the output of layers run on :func:`gather`'s
    rows) whose rows divide over the shards: shard ``i`` of ``n`` takes
    the ``i``-th n-th.  Rows that do not divide raise; narrow a later
    output whose rows do.  Outside, ``x``."""
    shard = current()
    if shard is None:
        return x
    if x.shape[-2] % shard.count:
        raise ValueError(f"{x.shape[-2]} frame rows do not split over "
                         f"{shard.count} shards: narrow a later output")
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


class Descent:
    """The gathers of a network's strided descent inside a row split
    (GwcNet's and MSNet's layers; outside a split it does nothing).  Before
    a layer of stride ``s``, :meth:`stride` gives the whole frame's rows
    of ``x`` (:func:`gather`) where the calling shard's rows of ``x`` do
    not stride whole, or would stride to fewer rows than ``depth``, the
    deepest halo that the layers after the stride read (a 3x3 convolution
    of dilation d reads d rows of each neighbour), and the shard then
    runs unsplit (the layers see the whole frame).  :meth:`join` narrows ``y``, made from the whole frame,
    to the shard's rows where the ``skip`` it is added to holds the
    shard's rows, and takes the shard back into its split; :meth:`rejoin`
    does so for the descent's last output.  As a context manager the
    shard is back in its split at the end, whatever happens."""

    def __init__(self):
        self._shard = None      # the shard suspended at the gather

    def __enter__(self) -> "Descent":
        return self

    def __exit__(self, *exc) -> None:
        if self._shard is not None:
            set_current(self._shard)
            self._shard = None

    def stride(self, x: torch.Tensor, s: int = 2,
               depth: int = 1) -> torch.Tensor:
        shard = current()
        if shard is None or (x.shape[-2] % s == 0
                             and x.shape[-2] // s >= depth):
            return x
        x = gather(x)
        self._shard = shard
        set_current(None)
        return x

    def height(self, x: torch.Tensor) -> int:
        """The rows of ``x``, a tensor of the shard's rows from before the
        gather, as the layers after it see them: the whole frame's while
        gathered."""
        return x.shape[-2] * (1 if self._shard is None else self._shard.count)

    def join(self, y: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        if self._shard is None or y.shape[-2] == skip.shape[-2]:
            return y
        return self.rejoin(y)

    def rejoin(self, y):
        """``y`` (a tensor, or a tuple of tensors of one shape), narrowed
        to the shard's rows if the descent gathered."""
        if self._shard is None:
            return y
        set_current(self._shard)
        self._shard = None
        if isinstance(y, torch.Tensor):
            return narrow(y)
        return tuple(narrow(torch.stack(y)).unbind(0))


def _publish(x: torch.Tensor, key: tuple,
             spec: Optional[Tuple[int, int, str]]):
    """Publish ``x`` at the calling shard's next exchange (its slot holds
    each shard's ``(tensor, stream, key, spec)``) and wait until every
    shard has; returns the shard's joined rows, once the round has run
    (:class:`Rounds`).  ``spec``: the ``(above, below, edge)`` of
    :func:`halo`, None for :func:`gather`."""
    shard = current()
    ex, i, r = shard.exchange, shard.index, shard.rounds
    slot = ex._slots[r % 2]
    shard.rounds += 1
    if i == ex.first:
        ex.rounds += 1
        ex.gather_rounds += spec is None
    slot[i] = (x, shard.stream, key + (r,), spec)
    shard.turns.pass_on(shard.thread)
    shard.turns.wait(shard.thread)
    with shard.turns.bounded():
        shard.run(r)
    return ex._outs[r % 2][i]


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
    x0, _, _, spec = slot[local[0]]
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
        if spec is None:
            whole = line.all_gather([slot[j][0] if j in digests else None
                                     for j in range(ex.count)], x0.device,
                                    timeout_s)
            keys = line.all_gather([digests.get(j)
                                    for j in range(ex.count)], home,
                                   timeout_s)
            for j in range(ex.count):
                if j not in digests:
                    slot[j] = (whole[j], None,
                               received(j, local[0], whole[j], keys[j]), spec)
        else:
            above, below, _ = spec
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
                    slot[j] = ({}, None, None, spec)
            for i in local:
                for w, (offset, _) in enumerate(wants[2:], 2):
                    j = i + offset
                    if got[i][w] is None or ex.local(j):
                        continue
                    pieces = slot[j][0]
                    pieces[offset < 0] = got[i][w]
                    slot[j] = (pieces, None, received(
                        j, i, got[i][w], got[i][offset > 0]), spec)
    ex.cross_rounds += 1
    ex.cross_seconds += time.perf_counter() - start


def _carry_back(side: _Side, d: dict, wanted: dict) -> dict:
    """Round ``side.r``'s backward of a split: from ``d``, each local
    shard's gradient of its joined rows, each local shard's gradient of
    its published tensor (None where ``wanted`` says none is needed).
    Every reader's gradient of a shard's rows goes back to that shard,
    across ranks through ``side.line``, beside the round's key digest; the
    terms are summed in one order whichever process holds each shard.
    Every rank of the line calls it, whatever ``wanted`` says."""
    start = time.perf_counter()
    n, local = side.count, sorted(d)
    spec = side.meta[local[0]][0]
    home = ("cpu" if side.line is not None and side.line.transport.staging
            else d[local[0]].device)
    values, wants = {}, []
    if spec is None:
        per = side.meta[local[0]][2]
        for i in local:
            values[i] = (d[i], i, torch.tensor([side.meta[i][1]],
                                               device=home))
        # Reader i + o hands shard i its part of its gradient.
        for o in range(1, n):
            wants += [(o, lambda e: e[2]), (o, lambda e, o=o: e[0].narrow(
                -2, (e[1] - o) % n * per, per))]
    else:
        above, below, edge = spec
        for i in local:
            g = d[i]
            values[i] = (
                g.narrow(-2, 0, above) if i > 0 else
                g.new_empty(g.shape[:-2] + (above, g.shape[-1])),
                g.narrow(-2, g.shape[-2] - below, below) if i < n - 1 else
                g.new_empty(g.shape[:-2] + (below, g.shape[-1])),
                torch.tensor([side.meta[i][1]], device=home))
        # From the shard below, its gradient of the rows it read above it
        # (this shard's last rows); from the shard above, of those below.
        wants = [(1, lambda e: e[2]), (-1, lambda e: e[2])]
        if above:
            wants.append((1, lambda e: e[0]))
        if below:
            wants.append((-1, lambda e: e[1]))
    xs = [values.get(j) for j in range(n)]
    wrap = spec is None
    got = (side.line.ring_fetch(xs, wants, wrap=wrap,
                                timeout_s=side.timeout_s)
           if side.line is not None else _local_ring(xs, wants, wrap))

    def term(j, i, digest, w=None):
        """Want ``w`` of shard ``j`` (None: none), from shard ``i``, whose
        key digest is want ``digest``."""
        theirs = int(got[j][digest])
        if theirs != side.meta[j][1]:
            raise RuntimeError(
                f"row split out of step in backward: shard {j} carries "
                f"back round {side.r}, shard {i} digest {theirs} from rank "
                f"{side.line.ranks[i] if side.line is not None else 'here'}")
        if w is None:
            return None
        if not side.local(i):
            side.back.cross_bytes += (got[j][w].numel()
                                      * got[j][w].element_size())
        return got[j][w]

    grads = {}
    for j in local:
        if spec is None:
            terms = [d[j].narrow(-2, j * per, per) if i == j
                     else term(j, i, 2 * ((i - j) % n) - 2,
                               2 * ((i - j) % n) - 1)
                     for i in range(n)]
            if not wanted[j]:
                grads[j] = None
                continue
            g = terms[0].clone()
            for t in terms[1:]:
                g.add_(t)
        else:
            _, _, rows, top = side.meta[j]
            upward = (term(j, j + 1, 0, 2 if above else None)
                      if j < n - 1 else None)
            downward = (term(j, j - 1, 1, 2 + bool(above) if below else None)
                        if j > 0 else None)
            if not wanted[j]:
                grads[j] = None
                continue
            g = d[j].narrow(-2, top, rows).clone()
            if edge == "replicate" and j == 0 and above:
                g.narrow(-2, 0, 1).add_(
                    d[j].narrow(-2, 0, above).sum(-2, keepdim=True))
            if edge == "replicate" and j == n - 1 and below:
                g.narrow(-2, rows - 1, 1).add_(d[j].narrow(
                    -2, top + rows, below).sum(-2, keepdim=True))
            if downward is not None:
                g.narrow(-2, 0, below).add_(downward)
            if upward is not None:
                g.narrow(-2, rows - above, above).add_(upward)
        grads[j] = g
    side.back.rounds += 1
    if side.line is not None:
        side.back.cross_rounds += 1
        side.back.cross_seconds += time.perf_counter() - start
    return grads


def _local_ring(xs: list, wants: Sequence[tuple], wrap: bool) -> list:
    """``Line.ring_fetch`` of a split whose shards are all this
    process's."""
    n = len(xs)
    out = [None] * n
    for i in range(n):
        if xs[i] is None:
            continue
        out[i] = [None] * len(wants)
        for w, (offset, piece) in enumerate(wants):
            j = (i + offset) % n if wrap else i + offset
            if 0 <= j < n and xs[j] is not None:
                out[i][w] = piece(xs[j]).to(piece(xs[i]).device)
    return out


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


def _halo_parts(ex: RowExchange, slot: list, i: int) -> List[torch.Tensor]:
    """Shard ``i``'s :func:`halo`: the rows above, its own, the rows
    below."""
    x, _, _, (above, below, edge) = slot[i]
    return [_neighbour(ex, slot, i, i - 1, above, edge, True), x,
            _neighbour(ex, slot, i, i + 1, below, edge, False)]


def _gathered(ex: RowExchange, slot: list, i: int) -> List[torch.Tensor]:
    """Every shard's rows in shard order, on shard ``i``'s device."""
    return [slot[i][0] if j == i else _fetch(ex, slot, i, j, None)
            for j in range(ex.count)]


def _neighbour(ex: RowExchange, slot: list, i: int, j: int, rows: int,
               edge: str, above: bool) -> torch.Tensor:
    """The ``rows`` rows of shard ``j`` next to shard ``i`` (its last rows
    when it lies above, its first below), on ``i``'s device; the frame's
    edge rows where there is no shard ``j``."""
    x = slot[i][0]
    if not 0 <= j < ex.count:
        return _edge(x, rows, above, edge)
    if rows == 0:
        return x[..., :0, :]
    return _fetch(ex, slot, i, j, (rows, above))


def _fetch(ex: RowExchange, slot: list, i: int, j: int,
           part: Optional[Tuple[int, bool]]) -> torch.Tensor:
    """Shard ``j``'s published tensor, or its last (``part = (rows,
    True)``) or first (``(rows, False)``) rows, on shard ``i``'s
    device."""
    x, _, key, _ = slot[i]
    other, stream, other_key, _ = slot[j]
    if other_key != key:
        raise RuntimeError(f"row split out of step: shard {i} "
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
    ex.bytes += other.numel() * other.element_size()
    if other.device == x.device:
        return other
    # A peer copy runs on the source device's current stream: make that the
    # stream the neighbour computed on, so it follows the neighbour's work.
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        return other.to(x.device)
