"""Deep3D's training step over a (data, tile, disp) mesh: the port of the
sharded step of ``__graft_entry__.dryrun_multichip`` (b), which jits one
full training step (the L1 loss, its gradients and the coupled-L2 Adam of
``make_optimizer``) with the batch split over ``data`` x ``disp`` and the
image rows over ``tile``, and lets GSPMD all-reduce the gradients.

The port places the work by hand, as ``parallel.synthesis`` does for
inference:

* the layout is the graft entry's (:func:`train_layout`): rows split over
  ``tile`` when ``tile`` divides the full view's rows, else ``tile``
  folds into the batch; a split whose down rows do not divide over
  ``tile``, whose sharding JAX's jit refuses, raises ``ValueError``;
* every shard runs Deep3D in training mode on its frames (and rows) on its
  own device; a ``tile`` group's shards run in threads of their own
  (``parallel.rows.ShardThreads``, eagerly: no CUDA graph), their
  row-mixing layers exchanging halo rows (``ops.rows``); each process
  runs its own shards of a group whose shards lie on several ranks, the
  exchanges crossing ranks through the group's ``Line`` (``Mesh.tile_lines``);
* a shard's loss is the sum of ``|pred - right|`` over its pixels over
  the global batch's element count, so that the shards' losses and
  gradients add up to those of one device on the whole batch;
* one backward runs over this process's shards' losses after their
  forwards: each halo exchange is an autograd node (``ops.rows._Round``)
  whose backward carries every joined row's gradient back to the shard it
  was read from, across ranks too, and sums a shard's terms in one order
  wherever its readers run; the losses are tied to the run's last round
  (``ops.rows.tie``), so every rank runs every round's backward, in
  reverse order;
* each shard's parameters are leaves of its own on its replica's storage,
  so each shard's gradient stays its own; the shards' losses and
  gradients are summed in mesh order, as a left fold, on this process's
  first device.  Across processes every shard's are all-gathered first
  (``parallel.transport``), so each rank sums the same values in the
  same order: the same bits as one process;
* one replica (model and Adam state) per distinct device of this
  process, and one on a rank that holds no entry of the mesh; each takes
  the same Adam step on the summed gradient, so the replicas stay
  identical bit for bit.

On CUDA a shard's backward gives the same bits run after run only under
``torch.use_deterministic_algorithms(True)`` (cuDNN's deterministic
algorithms; ``CUBLAS_WORKSPACE_CONFIG`` set before the first cuBLAS
call): without it every rank still ends each step with the same bits
(they sum the same all-gathered values), but not those of one process or
of another run.  Deep3D's training path has no operation that mode
refuses (its upsample is ``ops.rows.upsample_bilinear``).

The global branch's dropout mask is drawn for the whole batch from the
step's generator, as the single-device ``train.Trainer`` draws it, and
each shard takes its frames' rows of it (every row shard of a frame the
same).
"""

from __future__ import annotations

import copy
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core.config import TrainerConfig
from ..core.device import resolve_device, set_float32_precision
from ..models.deep3d import Deep3D, dropout_keep
from ..ops import rows
from ..train.trainer import make_optimizer
from .mesh import Mesh, same_device
from .rows import ShardThreads, exchanged


@dataclass(frozen=True)
class Layout:
    """How a global batch lies on a mesh: shard k sits at mesh index
    ``shards[k]`` (mesh order), holds frames ``frames[k]`` (start, stop)
    of the batch and, when ``row_split``, rows ``tile_of[k]`` of
    ``tile`` of them (``groups`` lists each tile group's shards)."""

    row_split: bool
    tile: int
    shards: Tuple[Tuple[int, int, int], ...]
    frames: Tuple[Tuple[int, int], ...]
    tile_of: Tuple[int, ...]
    groups: Tuple[Tuple[int, ...], ...]


def train_layout(mesh_shape, batch: int, full_shape,
                 down_shape) -> Layout:
    """The graft entry's layout of a ``batch`` of ``full_shape`` views
    (and ``down_shape`` down views) on a (data, tile, disp) mesh: the rows
    split over ``tile`` when ``tile`` divides the full rows, the batch over
    ``data`` x ``disp``; else ``tile`` folds into the batch, over
    ``data`` x ``tile`` x ``disp``.  Raises ``ValueError`` where the rows
    split and the down rows do not divide over ``tile`` (JAX's jit
    refuses that sharding of the down view), where the full view is not
    4x the down view (as JAX's blend needs), or where the batch does not
    divide over its groups."""
    data, tile, disp = mesh_shape
    (fh, fw), (dh, dw) = full_shape, down_shape
    row_split = tile > 1 and fh % tile == 0
    if row_split and dh % tile:
        raise ValueError(
            f"the {fh} full rows split over tile {tile}, and the {dh} rows "
            f"of the {dh}x{dw} down view do not divide over tile {tile}: "
            f"JAX's jit refuses that sharding of the down view")
    if row_split and (fh, fw) != (4 * dh, 4 * dw):
        raise ValueError(f"a {fh}x{fw} view is not 4x the down view "
                         f"{dh}x{dw}")
    groups = data * disp * (1 if row_split else tile)
    if batch % groups:
        raise ValueError(f"batch {batch} not divisible over the "
                         f"{groups} batch groups of mesh {mesh_shape}")
    per = batch // groups
    shards, frames, tile_of, members = [], [], [], {}
    for k, (d, t, p) in enumerate(np.ndindex(data, tile, disp)):
        g = d * disp + p if row_split else (d * tile + t) * disp + p
        shards.append((d, t, p))
        frames.append((g * per, (g + 1) * per))
        tile_of.append(t)
        members.setdefault(g, []).append(k)
    return Layout(row_split, tile, tuple(shards), tuple(frames),
                  tuple(tile_of),
                  tuple(tuple(members[g]) for g in sorted(members)))


def alias(module: nn.Module) -> nn.Module:
    """A copy of ``module`` whose parameters are new leaves on the same
    storage: its forward reads the module's current weights, and its
    gradients stay apart from the module's."""
    memo = {id(p): nn.Parameter(p.detach()) for p in module.parameters()}
    return copy.deepcopy(module, memo)


class ShardedTrainStep:
    """Deep3D's training step on ``mesh`` (a ``parallel.Mesh``): the
    graft entry's sharded step, :meth:`step` taking the global batch.
    ``model`` holds the starting weights (it becomes the replica of its
    own device, if that device is in the mesh); ``config`` the optimizer's
    (``train.trainer.make_optimizer``); ``dropout`` whether the global
    branch drops units, from a generator on this process's first device
    seeded with ``seed``.  A mesh that names a CUDA device without CUDA
    raises (``core.device``); nothing runs on the CPU unless the mesh
    says so.

    :attr:`replicas` maps each device to its model (training mode) and
    :attr:`optimizers` to its Adam; :attr:`model` is this process's first
    one.  :attr:`layout` is the last step's, and :attr:`halo` what its
    row split exchanged (``parallel.rows.exchanged``, forward and
    backward; None without a row split).  Every rank of a mesh over
    processes makes the step (its ``tile`` groups' lines are made here)
    and calls :meth:`step` with the same batch."""

    def __init__(self, model: Deep3D, config: TrainerConfig, mesh: Mesh,
                 dropout: bool = True, seed: int = 0):
        for device in mesh.devices.flat:
            resolve_device(device)
        set_float32_precision("float32")
        self.mesh = mesh
        self.config = config
        self.dropout = dropout
        self.home = mesh.first_device
        devices = mesh.distinct_devices() or [self.home]
        own = next(model.parameters()).device
        self.replicas = {dev: (model if same_device(own, dev)
                               else copy.deepcopy(model).to(dev)).train()
                         for dev in devices}
        self.optimizers = {dev: make_optimizer(r.parameters(), config)
                           for dev, r in self.replicas.items()}
        self.generator = torch.Generator(device=self.home)
        self.generator.manual_seed(seed)
        self._aliases = {}
        self._threads = ShardThreads()
        self._lines = mesh.tile_lines() if mesh.shape[1] > 1 else None
        self.layout: Optional[Layout] = None
        self.halo: Optional[dict] = None

    @property
    def model(self) -> Deep3D:
        return next(iter(self.replicas.values()))

    def _alias_at(self, index) -> nn.Module:
        """Shard ``index``'s parameters: an alias of its device's
        replica, made once."""
        if index not in self._aliases:
            device = self.mesh.devices[index]
            replica = next(r for d, r in self.replicas.items()
                           if same_device(d, device))
            self._aliases[index] = alias(replica)
        return self._aliases[index]

    def step(self, left_full: torch.Tensor, left_down: torch.Tensor,
             right_full: torch.Tensor) -> torch.Tensor:
        """One training step on the global batch (NCHW, 0..1, any
        device): the loss, on this process's first device, as one device
        computes it on the whole batch (``train.Trainer.train_step``)."""
        mesh = self.mesh
        layout = train_layout(mesh.shape, left_full.shape[0],
                              tuple(left_full.shape[-2:]),
                              tuple(left_down.shape[-2:]))
        self.layout = layout
        keep = None
        if self.dropout:
            branch = self.model.DisparityEstimationNetwork_0
            keep = dropout_keep(self.generator, (
                left_full.shape[0],
                branch.FeedForwardBranch_0.Dense_0.out_features), self.home)
        count = right_full.numel()
        local = [k for k, index in enumerate(layout.shards)
                 if mesh.is_local(index)]
        losses = {}

        def shard_loss(k):
            index = layout.shards[k]
            device = mesh.devices[index]
            start, stop = layout.frames[k]

            def part(x):
                x = x[start:stop]
                if layout.row_split:
                    per = x.shape[-2] // layout.tile
                    x = x.narrow(-2, layout.tile_of[k] * per, per)
                return x.to(device)

            pred = self._alias_at(index)(
                part(left_full), part(left_down),
                None if keep is None else keep[start:stop])
            losses[k] = (pred - part(right_full)).abs().sum() / count

        exchanges = []
        with torch.enable_grad():
            if layout.row_split:
                # Groups index as mesh.tile_lines(): (data, disp) pairs.
                held = [g for g, group in enumerate(layout.groups)
                        if any(k in local for k in group)]
                _, exchanges = self._threads.run(
                    [[(mesh.devices[layout.shards[k]],
                       functools.partial(shard_loss, k)) if k in local
                      else None for k in layout.groups[g]] for g in held],
                    [self._lines[g] for g in held] if self._lines else None)
                token = exchanges[0].token if exchanges else None
                losses = {k: rows.tie(loss, token)
                          for k, loss in losses.items()}
            else:
                for k in local:
                    shard_loss(k)
            if losses:
                torch.autograd.backward([losses[k] for k in local])
        self.halo = exchanged(exchanges) if exchanges else None
        total = self._reduce(layout, local, losses)
        for device, replica in self.replicas.items():
            flat = total if same_device(device, self.home) else \
                total.to(device)
            offset = 1
            for p in replica.parameters():
                p.grad = flat[offset:offset + p.numel()].view_as(p)
                offset += p.numel()
            self.optimizers[device].step()
        return total[0]

    def _reduce(self, layout: Layout, local, losses) -> torch.Tensor:
        """``[loss, every gradient flattened]`` summed over the shards in
        mesh order (a left fold), on this process's first device."""
        vectors = {}
        for k in local:
            params = list(self._alias_at(layout.shards[k]).parameters())
            vectors[k] = torch.cat(
                [losses[k].detach().reshape(1).to(self.home)]
                + [(p.grad if p.grad is not None else torch.zeros_like(p))
                   .reshape(-1).to(self.home) for p in params])
            for p in params:
                p.grad = None
        mesh = self.mesh
        if mesh.processes is None:
            parts = [vectors[k] for k in range(len(layout.shards))]
        else:
            params = list(self.model.parameters())
            like = torch.empty(1 + sum(p.numel() for p in params),
                               dtype=params[0].dtype, device="meta")
            parts = mesh.transport.all_gather_parts(
                [vectors.get(k) for k in range(len(layout.shards))],
                [int(mesh.processes[index]) for index in layout.shards],
                self.home, like=like)
        total = parts[0].clone()
        for part in parts[1:]:
            total += part
        return total

    def replicas_identical(self) -> bool:
        """Whether every replica's weights and Adam state equal the first
        one's bit for bit."""
        def state(device):
            opt = self.optimizers[device]
            return [t.cpu() for p in self.replicas[device].parameters()
                    for t in [p.detach()] + [
                        v for v in opt.state.get(p, {}).values()
                        if torch.is_tensor(v)]]

        devices = list(self.replicas)
        first = state(devices[0])
        return all(len(first) == len(other) and all(
            torch.equal(a, b) for a, b in zip(first, other))
            for other in map(state, devices[1:]))

    def close(self) -> None:
        """Stop the shard threads."""
        self._threads.close()
