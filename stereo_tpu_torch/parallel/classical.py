"""The classical matcher over a (data, tile, disp) mesh with explicit
collectives (port of ``stereo_tpu/parallel/classical.py``).

* ``data`` — the leading batch axis of (N, 3, H, W) frame batches;
* ``tile`` — image rows.  One ring exchange of ``k * (large_mbm + cost_r
  + 1)`` full-res rows with the neighbouring shards makes every window
  stage local; the ring's wrap at the global top and bottom is the
  reference's ``pad_index`` wrap.
* ``disp`` — the cost volume's disparity axis.  Each disp shard builds only
  its chunk of the volume; the winner is a local argmax and a cross-shard
  (value, index) reduction, and secondary matching fetches each pixel's
  dense-SAD window and three MBM costs from the shard that owns them.

Where ``disp == 1`` the kernel path runs ``matching_core`` and
``sampled_window`` in their row-halo mode (``rows_prepadded``) on each
row shard's exchanged rows; otherwise the blockwise path runs in plain
PyTorch, as the JAX package runs XLA there.

A shard's values are held in (tile, disp) nested lists, ``x[ti][pi]`` on
device ``mesh[data, ti, pi]``.  The collectives are plain functions over
the lists of one ring or one disp group; a reduction is taken on the first
shard's device and handed to the others.  No shard writes in place into a
tensor it received: on a mesh that repeats a device, ``.to()`` hands over
the sender's own tensor.

On a mesh that spans processes (``Mesh.processes``) any axis may cross
ranks.  A rank holds values for its own entries only (None elsewhere),
runs the local maps on those, and each collective whose list crosses
ranks takes that list's ``parallel.transport.Line``: the ring's exchanges
become point-to-point messages to the ring neighbours, the argmax and the
sums become all-reduces over the disp group (each rank reducing its own
entries first), the row gather an all-gather.  Every maximum, minimum and
sum is exact (each sum has one non-zero term per element), so the result
equals the same mesh in one process bit for bit.

Correctness contract: equal to the single-device engine
(``stereo_tpu_torch.matching.classical``).
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch
from torch.distributed import ReduceOp

from .. import ops
from ..core.config import MatchingConfig, MeshConfig
from ..ops.boxfilter import box_sum_2d
from ..ops.cost_volume import MAX_INTENSITY
from ..ops.cuda import matching_core, sampled_window
from ..ops.fills import _select_fill
from ..ops.gather import take_lane, take_window_lanes
from ..ops.refinement import refine_from_window, sampled_sad_volume
from .mesh import Mesh, Placement, make_mesh


def k_halo_rows(config: MatchingConfig) -> int:
    """Full-resolution rows exchanged over the ring per side."""
    return config.k * (config.large_mbm_radius + config.cost_patch_radius + 1)


# -- collectives over one ring (tile) or one disp group ----------------------
#
# Each takes the list of the ring or group and, where the list crosses
# processes, its ``line`` (None at other ranks' entries, which the line's
# transport reaches); each returns values at the local entries only.

def _ring_fetch(xs: List[Optional[torch.Tensor]], wants, line=None) -> list:
    """For each local entry i and each ``(offset, piece)`` of ``wants``,
    ``piece(xs[(i + offset) % n])`` on entry i's device."""
    if line is not None:
        return line.ring_fetch(xs, wants)
    n = len(xs)
    return [[piece(xs[(i + offset) % n]).to(x.device)
             for offset, piece in wants] for i, x in enumerate(xs)]


def _ring_halo_rows(xs: List[torch.Tensor], halo: int,
                    line=None) -> List[torch.Tensor]:
    """Extend each shard's rows with ``halo`` rows of its ring neighbours
    (wrap-around at the global borders, the ``pad_index`` wrap; a ring of
    one wraps onto itself).  (H_local, W) -> (H_local + 2*halo, W)."""
    pieces = _ring_fetch(xs, [(-1, lambda x: x[-halo:]),
                              (1, lambda x: x[:halo])], line)
    return [None if x is None else torch.cat([above, x, below], dim=0)
            for x, (above, below) in zip(xs, [p or (None, None)
                                              for p in pieces])]


def _ring_from_previous(xs: List[torch.Tensor],
                        line=None) -> List[torch.Tensor]:
    """Each shard receives the previous shard's value (wrap at the top)."""
    return [p and p[0] for p in _ring_fetch(xs, [(-1, lambda x: x)], line)]


def _to_each(value: torch.Tensor, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """``value`` handed to the device of each of ``xs`` (None stays)."""
    return [None if x is None else value.to(x.device) for x in xs]


def _local_reduce(op, xs: List[Optional[torch.Tensor]]) -> torch.Tensor:
    """``op`` over this process's entries, on the first one's device."""
    local = [x for x in xs if x is not None]
    dev = local[0].device
    return functools.reduce(op, [x.to(dev) for x in local])


def _cross_chip_argmax(values: List[torch.Tensor],
                       global_idx: List[torch.Tensor], line=None):
    """First-maximum-wins argmax across shards: the max of the values, then
    the least global index among the shards that reach it (ties -> the
    smallest global index, the reference's strict ``>`` scan).  Across
    processes each rank reduces its own shards, then the ranks all-reduce
    (MAX, then MIN on the candidates)."""
    gmax = _local_reduce(torch.maximum, values)
    if line is not None:
        gmax = line.all_reduce(gmax, ReduceOp.MAX)
    dev = gmax.device
    big = torch.iinfo(_first(global_idx).dtype).max
    cand = _local_reduce(torch.minimum, [
        None if v is None else torch.where(v.to(dev) == gmax, i.to(dev), big)
        for v, i in zip(values, global_idx)])
    if line is not None:
        cand = line.all_reduce(cand, ReduceOp.MIN)
    return _to_each(gmax, values), _to_each(cand, values)


def _psum(xs: List[torch.Tensor], line=None) -> List[torch.Tensor]:
    """The sum over the shards.  Each use has one non-zero term per
    element, so the shards' order cannot change a bit."""
    total = _local_reduce(torch.add, xs)
    if line is not None:
        total = line.all_reduce(total, ReduceOp.SUM)
    return _to_each(total, xs)


def _owned_gather(volumes: List[torch.Tensor], local_pos: List[torch.Tensor],
                  chunk: int, line=None) -> List[torch.Tensor]:
    """Fetch ``volume[..., local_pos]`` from whichever disp shard owns it:
    mask out-of-chunk positions locally, sum across the shards."""
    parts = []
    for volume, pos in zip(volumes, local_pos):
        if volume is None:
            parts.append(None)
            continue
        owned = (pos >= 0) & (pos < chunk)
        vals = take_lane(volume, torch.clamp(pos, 0, chunk - 1))
        parts.append(torch.where(owned, vals, 0.0))
    return _psum(parts, line)


def _all_gather_rows(xs: List[torch.Tensor],
                     line=None) -> List[torch.Tensor]:
    """Every shard's rows, concatenated in ring order, on each local
    shard's own device."""
    parts = xs if line is None else line.all_gather(xs, _first(xs).device)
    by_device = {}
    out = []
    for x in xs:
        if x is None:
            out.append(None)
            continue
        if x.device not in by_device:
            by_device[x.device] = torch.cat([y.to(x.device) for y in parts])
        out.append(by_device[x.device])
    return out


# -- per-device maps over a (tile, disp) grid of shards ----------------------
#
# A grid holds None at the entries of other processes; the maps run the
# local shards only.

def _first(xs):
    """The first value that is not None."""
    return next(x for x in xs if x is not None)


def _first_shard(grid):
    """The first local shard of a (tile, disp) grid."""
    return _first(x for row in grid for x in row)


def _each(fn, *grids):
    """``fn`` on every local shard of the grids."""
    return [[None if any(a is None for a in args) else fn(*args)
             for args in zip(*rows)] for rows in zip(*grids)]


def _along_tile(fn, *grids, lines=None):
    """``fn`` on the lists of each ring (one per disp index) that holds a
    local shard, with that ring's line (``lines[p]``)."""
    n_tile, n_disp = len(grids[0]), len(grids[0][0])
    cols = []
    for p in range(n_disp):
        lists = [[g[t][p] for t in range(n_tile)] for g in grids]
        if all(x is None for x in lists[0]):
            cols.append([None] * n_tile)
        else:
            cols.append(fn(*lists, line=lines and lines[p]))
    return [[cols[p][t] for p in range(n_disp)] for t in range(n_tile)]


def _along_disp(fn, *grids, lines=None):
    """``fn`` on the lists of each disp group (one per tile index) that
    holds a local shard, with that group's line (``lines[t]``)."""
    return [[None] * len(rows[0]) if all(x is None for x in rows[0])
            else fn(*rows, line=lines and lines[t])
            for t, rows in enumerate(zip(*grids))]


def _sharded_frame(left_rgb, right_rgb, config: MatchingConfig,
                   use_kernels: bool = False, lines=None):
    """One frame over a (tile, disp) grid of shards.

    ``left_rgb``/``right_rgb``: ``[ti][pi]`` (3, H_local, W) row shards,
    each on its device (None at other processes' entries).  Returns the
    ``[ti][pi]`` (H_local, W) disparity rows.  ``lines``: for a grid that
    spans processes, ``(tile_lines, disp_lines)``, the ``Line`` of each
    ring (by disp index) and of each disp group (by tile index), None
    where one process holds it.

    With ``use_kernels=True`` (requires a disp axis of 1) cost volume,
    aggregation, WTA and the dense-SAD window run in ``matching_core`` and
    ``sampled_window`` on each row shard's halo-extended rows: the kernels
    on CUDA shards, their plain versions on CPU ones.  Equal to the
    blockwise path.
    """
    c = config
    k = c.k
    n_tile, n_disp = len(left_rgb), len(left_rgb[0])
    num_dd = c.num_disparities_down
    if num_dd % n_disp:
        raise ValueError(f"disparity count {num_dd} not divisible by "
                         f"disp axis {n_disp}")
    chunk = num_dd // n_disp
    halo_down = c.large_mbm_radius + c.cost_patch_radius + 1
    halo_full = k * halo_down
    c0 = [[p * chunk for p in range(n_disp)] for _ in range(n_tile)]
    tile_index = [[t] * n_disp for t in range(n_tile)]
    tile_lines, disp_lines = lines or (None, None)
    along_tile = functools.partial(_along_tile, lines=tile_lines)
    along_disp = functools.partial(_along_disp, lines=disp_lines)

    local_h = _first_shard(left_rgb).shape[-2]
    local_hd = local_h // k
    h_full = local_h * n_tile

    # Stage 1: grayscale (local).
    lg = _each(ops.rgb_to_grayscale, left_rgb)
    rg = _each(ops.rgb_to_grayscale, right_rgb)

    # Halo exchange: one ring exchange of input rows makes every windowed
    # stage local.
    lg_e = along_tile(functools.partial(_ring_halo_rows, halo=halo_full), lg)
    rg_e = along_tile(functools.partial(_ring_halo_rows, halo=halo_full), rg)

    # Stage 2: mean-pool downscale (local, halo rows aligned to k).
    ld = _each(lambda x: ops.mean_pool(x, k), lg_e)
    rd = _each(lambda x: ops.mean_pool(x, k), rg_e)
    w_d = _first_shard(ld).shape[-1]

    if use_kernels:
        if n_disp != 1:
            raise ValueError("the kernel path requires disp axis == 1")
        sad_r = c.sad_patch_radius
        rows = slice(halo_full - sad_r, halo_full + local_h + sad_r)

        def refine_shard(ld, rd, lg_e, rg_e):
            # Stages 3-5 in matching_core on the exchanged rows (its halo
            # is halo_down - 1 rows), stage 6's window scan on the
            # sad_r-extended full-res rows.
            disparity, mbm = matching_core(ld[1:-1], rd[1:-1], c,
                                           rows_prepadded=True)
            window = sampled_window(lg_e[rows], rg_e[rows], disparity, c,
                                    rows_prepadded=True)
            return k * refine_from_window(torch.movedim(window, 0, -1),
                                          disparity, mbm[0], mbm[1], mbm[2],
                                          k)

        scaled = _each(refine_shard, ld, rd, lg_e, rg_e)
        # The vertical fill needs the row above each local block: the
        # previous shard's last refined row over the ring.
        neighbor_last = along_tile(
            lambda xs, line: _ring_from_previous(
                [None if x is None else x[-1:] for x in xs], line), scaled)
        prev_row = _each(lambda n, s: torch.cat([n, s[:-1]], dim=0),
                         neighbor_last, scaled)
    else:
        # Stage 3: the inverted-SAD cost volume of this shard's disparity
        # chunk only; stage 4: MBM aggregation (local to the chunk).
        area = (2 * c.cost_patch_radius + 1) ** 2
        r = c.cost_patch_radius

        def aggregate_chunk(ld, rd, c0):
            rd_base = torch.roll(rd, c.min_disparity_down + c0, dims=-1)
            planes = [area * MAX_INTENSITY - box_sum_2d(
                torch.abs(ld - torch.roll(rd_base, t, dims=-1)), r, r)
                for t in range(chunk)]
            return ops.mbm_aggregate(torch.stack(planes, dim=-1),
                                     c.small_mbm_radius, c.mid_mbm_radius,
                                     c.large_mbm_radius)

        aggregated = _each(aggregate_chunk, ld, rd, c0)

        # Stage 5: WTA — local argmax over the chunk, then the cross-shard
        # (value, index) reduction over the disp axis.
        local_val = _each(lambda a: torch.amax(a, dim=-1), aggregated)
        local_best = _each(lambda a, c0: torch.argmax(a, dim=-1) + c0,
                           aggregated, c0)
        d_idx = along_disp(
            lambda v, i, line: _cross_chip_argmax(v, i, line)[1],
            local_val, local_best)
        disparity = _each(lambda d: (d + c.min_disparity_down).to(
            torch.float32), d_idx)

        # Stage 6: secondary matching.  Dense SAD planes only for this
        # chunk's window range; window taps and MBM parabola costs fetched
        # from their owners.
        win = 2 * k + 3
        n_dense_local = k * chunk + k + 3
        d_start = k * (c.min_disparity_down - 1) - 1   # global dense offset 0
        dense = _each(lambda lg_e, rg_e, c0: sampled_sad_volume(
            lg_e, rg_e, k, c.sad_patch_radius, d_start + k * c0,
            n_dense_local), lg_e, rg_e, c0)

        def owned_window(dense, d_idx, c0):
            owned = (d_idx >= c0) & (d_idx < c0 + chunk)
            start = torch.clamp(k * (d_idx - c0), 0, n_dense_local - win)
            window = take_window_lanes(dense, start, win)
            return torch.where(owned[..., None], window, 0.0)

        window = along_disp(_psum, _each(owned_window, dense, d_idx, c0))
        mbm = [along_disp(
            functools.partial(_owned_gather, chunk=chunk), aggregated,
            _each(lambda d, c0: torch.remainder(d + j, num_dd) - c0,
                  d_idx, c0)) for j in (-1, 0, 1)]
        refined = _each(lambda w, d, a, b, e: refine_from_window(
            w, d, a, b, e, k), window, disparity, *mbm)
        scaled = _each(lambda x: k * x[halo_down: halo_down + local_hd],
                       refined)
        prev_row = _each(
            lambda x: k * x[halo_down - 1: halo_down - 1 + local_hd], refined)

    # Stages 7-8: fills.  The vertical fill's bilateral colours index rows
    # k*x, (k+1)*x, k*x+i of the global stride-k column grid: gather the
    # (H, W_d) grid once over the ring, keep everything else local.
    grid = along_tile(_all_gather_rows,
                      _each(lambda x: x[:, ::k][:, :w_d], lg))

    def fill_shard(scaled, prev_row, grid, lg, ti):
        x_abs = ti * local_hd + torch.arange(local_hd, device=scaled.device)
        prev_color = grid[torch.clamp(k * x_abs, 0, h_full - 1)]
        next_color = grid[torch.clamp((k + 1) * x_abs, 0, h_full - 1)]
        rows = [scaled]
        for i in range(1, k):
            current_color = grid[torch.clamp(k * x_abs + i, 0, h_full - 1)]
            fill = _select_fill(scaled, prev_row, prev_color, next_color,
                                current_color, float(i), float(k),
                                float(c.threshold))
            # absolute row block 0 replicates its anchor (ops/fills.py)
            rows.append(torch.where((x_abs == 0)[:, None], scaled, fill))
        vfilled = torch.stack(rows, dim=1).reshape(local_hd * k, w_d)
        return ops.horizontal_fill(lg, vfilled, k, float(c.threshold))

    return _each(fill_shard, scaled, prev_row, grid, lg, tile_index)


class ShardedClassicalEngine:
    """Batch engine over a (data, tile, disp) mesh (default: the first
    ``mesh_config.num_devices`` cards; pass ``mesh`` for another list).

    Requirements (checked): batch divisible by ``data``; image height
    divisible by ``k * tile``, each row shard at least the ring's halo
    (``k_halo_rows``); downscaled disparity count divisible by ``disp``.
    Results are gathered on the mesh's first device.

    On a mesh that spans processes every rank calls with the same global
    batch, runs its own entries, and receives the whole result on its
    first device.  The rings and disp groups that cross ranks get their
    ``Line`` (and process group) here, in one order on every rank.
    """

    def __init__(self, config: MatchingConfig, mesh_config: MeshConfig,
                 mesh: Optional[Mesh] = None):
        self.config = config
        self.mesh_config = mesh_config
        self.mesh = mesh if mesh is not None else make_mesh(mesh_config)
        mc = mesh_config
        if self.mesh.shape != (mc.data, mc.tile, mc.disp):
            raise ValueError(f"mesh of shape {self.mesh.shape} for "
                             f"{mesh_config}")
        if config.height % (config.k * mc.tile):
            raise ValueError("height must divide k * tile")
        if config.num_disparities_down % mc.disp:
            raise ValueError("disparity count must divide disp axis")
        if config.height // mc.tile < k_halo_rows(config):
            raise ValueError(f"a row shard of {config.height // mc.tile} "
                             f"rows cannot lend the ring's "
                             f"{k_halo_rows(config)}-row halo")
        self.use_kernels = self._select_kernels(config, mc, self.mesh)
        self._in = Placement(self.mesh, ("data", None, "tile", None))
        self._out = Placement(self.mesh, ("data", "tile", None))
        self._lines = [
            ([self.mesh.line([(d, t, p) for t in range(mc.tile)])
              for p in range(mc.disp)],
             [self.mesh.line([(d, t, p) for p in range(mc.disp)])
              for t in range(mc.tile)]) for d in range(mc.data)]

    @staticmethod
    def _select_kernels(config: MatchingConfig, mc: MeshConfig,
                        mesh: Mesh) -> bool:
        """The single-device ``impl`` rule: ``"cuda"`` demands the kernel
        path, ``"torch"`` takes the blockwise path, ``"auto"`` takes the
        kernel path where it is eligible (an unsharded disparity axis).  On
        CPU devices the kernel path runs the kernels' plain versions."""
        c = config
        eligible = (mc.disp == 1 and c.height % c.k == 0
                    and c.width % c.k == 0
                    and k_halo_rows(c) >= c.sad_patch_radius
                    and c.large_mbm_radius >= max(c.small_mbm_radius,
                                                  c.mid_mbm_radius))
        if c.impl == "cuda":
            if not eligible:
                raise ValueError("impl='cuda' needs disp axis == 1, "
                                 "k-divisible dims, halo >= sad radius, and "
                                 "the large MBM radius the largest")
            if any(d.type != "cuda" for d in mesh.devices.flat):
                raise ValueError("MatchingConfig(impl='cuda') needs a mesh "
                                 "of CUDA devices")
            return True
        if c.impl == "torch":
            return False
        return eligible

    def compute_disparity_maps(self, left_batch, right_batch) -> torch.Tensor:
        """(N, 3, H, W) x2 -> (N, H, W); N must divide the data axis."""
        left = torch.as_tensor(left_batch).to(torch.float32)
        right = torch.as_tensor(right_batch).to(torch.float32)
        data, n_tile, n_disp = self.mesh.shape
        if left.shape[0] % data:
            raise ValueError("batch size must divide data axis")
        lefts, rights = self._in.shard(left), self._in.shard(right)
        out = np.empty(self.mesh.shape, dtype=object)

        def frame_of(shards, d, f):
            return [[None if shards[d, t, p] is None else shards[d, t, p][f]
                     for p in range(n_disp)] for t in range(n_tile)]

        with torch.no_grad():
            for d in range(data):
                if all(x is None for x in lefts[d].flat):
                    continue        # another process's data row
                frames = [_sharded_frame(
                    frame_of(lefts, d, f), frame_of(rights, d, f),
                    self.config, self.use_kernels, self._lines[d])
                    for f in range(left.shape[0] // data)]
                for t, p in np.ndindex(n_tile, n_disp):
                    if lefts[d, t, p] is not None:
                        out[d, t, p] = torch.stack([fr[t][p]
                                                    for fr in frames])
        return self._out.gather(out)

    def warmup(self) -> None:
        c = self.config
        x = torch.zeros((self.mesh_config.data, 3, c.height, c.width))
        self.compute_disparity_maps(x, x)
