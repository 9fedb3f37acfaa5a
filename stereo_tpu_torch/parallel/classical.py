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

Correctness contract: equal to the single-device engine
(``stereo_tpu_torch.matching.classical``).
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch

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

def _ring_halo_rows(xs: List[torch.Tensor], halo: int) -> List[torch.Tensor]:
    """Extend each shard's rows with ``halo`` rows of its ring neighbours
    (wrap-around at the global borders, the ``pad_index`` wrap; a ring of
    one wraps onto itself).  (H_local, W) -> (H_local + 2*halo, W)."""
    n = len(xs)
    return [torch.cat([xs[(i - 1) % n][-halo:].to(x.device), x,
                       xs[(i + 1) % n][:halo].to(x.device)], dim=0)
            for i, x in enumerate(xs)]


def _ring_from_previous(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each shard receives the previous shard's value (wrap at the top)."""
    n = len(xs)
    return [xs[(i - 1) % n].to(x.device) for i, x in enumerate(xs)]


def _to_each(value: torch.Tensor, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """``value`` handed to the device of each of ``xs``."""
    return [value.to(x.device) for x in xs]


def _cross_chip_argmax(values: List[torch.Tensor],
                       global_idx: List[torch.Tensor]):
    """First-maximum-wins argmax across shards: the max of the values, then
    the least global index among the shards that reach it (ties -> the
    smallest global index, the reference's strict ``>`` scan)."""
    dev = values[0].device
    vals = [v.to(dev) for v in values]
    gmax = functools.reduce(torch.maximum, vals)
    big = torch.iinfo(global_idx[0].dtype).max
    cand = [torch.where(v == gmax, i.to(dev), big)
            for v, i in zip(vals, global_idx)]
    return (_to_each(gmax, values),
            _to_each(functools.reduce(torch.minimum, cand), values))


def _psum(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over the shards.  Each use has one non-zero term per
    element, so the shards' order cannot change a bit."""
    dev = xs[0].device
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(dev)
    return _to_each(total, xs)


def _owned_gather(volumes: List[torch.Tensor], local_pos: List[torch.Tensor],
                  chunk: int) -> List[torch.Tensor]:
    """Fetch ``volume[..., local_pos]`` from whichever disp shard owns it:
    mask out-of-chunk positions locally, sum across the shards."""
    parts = []
    for volume, pos in zip(volumes, local_pos):
        owned = (pos >= 0) & (pos < chunk)
        vals = take_lane(volume, torch.clamp(pos, 0, chunk - 1))
        parts.append(torch.where(owned, vals, 0.0))
    return _psum(parts)


def _all_gather_rows(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Every shard's rows, concatenated in ring order, on each device."""
    by_device = {}
    for x in xs:
        if x.device not in by_device:
            by_device[x.device] = torch.cat([y.to(x.device) for y in xs])
    return [by_device[x.device] for x in xs]


# -- per-device maps over a (tile, disp) grid of shards ----------------------

def _each(fn, *grids):
    """``fn`` on every shard of the grids."""
    return [[fn(*args) for args in zip(*rows)] for rows in zip(*grids)]


def _along_tile(fn, *grids):
    """``fn`` on the lists of each ring (one per disp index)."""
    n_tile, n_disp = len(grids[0]), len(grids[0][0])
    cols = [fn(*[[g[t][p] for t in range(n_tile)] for g in grids])
            for p in range(n_disp)]
    return [[cols[p][t] for p in range(n_disp)] for t in range(n_tile)]


def _along_disp(fn, *grids):
    """``fn`` on the lists of each disp group (one per tile index)."""
    return [fn(*rows) for rows in zip(*grids)]


def _sharded_frame(left_rgb, right_rgb, config: MatchingConfig,
                   use_kernels: bool = False):
    """One frame over a (tile, disp) grid of shards.

    ``left_rgb``/``right_rgb``: ``[ti][pi]`` (3, H_local, W) row shards,
    each on its device.  Returns the ``[ti][pi]`` (H_local, W) disparity
    rows.

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

    local_h = left_rgb[0][0].shape[-2]
    local_hd = local_h // k
    h_full = local_h * n_tile

    # Stage 1: grayscale (local).
    lg = _each(ops.rgb_to_grayscale, left_rgb)
    rg = _each(ops.rgb_to_grayscale, right_rgb)

    # Halo exchange: one ring exchange of input rows makes every windowed
    # stage local.
    lg_e = _along_tile(lambda xs: _ring_halo_rows(xs, halo_full), lg)
    rg_e = _along_tile(lambda xs: _ring_halo_rows(xs, halo_full), rg)

    # Stage 2: mean-pool downscale (local, halo rows aligned to k).
    ld = _each(lambda x: ops.mean_pool(x, k), lg_e)
    rd = _each(lambda x: ops.mean_pool(x, k), rg_e)
    w_d = ld[0][0].shape[-1]

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
        neighbor_last = _along_tile(
            lambda xs: _ring_from_previous([x[-1:] for x in xs]), scaled)
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
        d_idx = _along_disp(lambda v, i: _cross_chip_argmax(v, i)[1],
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

        window = _along_disp(_psum, _each(owned_window, dense, d_idx, c0))
        mbm = [_along_disp(
            lambda vol, pos: _owned_gather(vol, pos, chunk), aggregated,
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
    grid = _along_tile(_all_gather_rows,
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
        with torch.no_grad():
            for d in range(data):
                frames = [_sharded_frame(
                    [[lefts[d, t, p][f] for p in range(n_disp)]
                     for t in range(n_tile)],
                    [[rights[d, t, p][f] for p in range(n_disp)]
                     for t in range(n_tile)], self.config, self.use_kernels)
                    for f in range(lefts[d, 0, 0].shape[0])]
                for t, p in np.ndindex(n_tile, n_disp):
                    out[d, t, p] = torch.stack([fr[t][p] for fr in frames])
        return self._out.gather(out)

    def warmup(self) -> None:
        c = self.config
        x = torch.zeros((self.mesh_config.data, 3, c.height, c.width))
        self.compute_disparity_maps(x, x)
