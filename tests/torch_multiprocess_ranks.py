"""The ranks of ``tests/test_torch_multiprocess.py``: each case of
:data:`CASES` run by every rank of a gloo group on the CPU, each rank
saving what it received, and rank 0 also the same mesh in one process.

A spawned child imports the module of the function it runs, so this one
imports only numpy, torch and the port (the test modules import JAX).
Run a group with ``stereo_tpu_torch.parallel.transport.spawn_ranks(run,
4, STORE, args=(OUT_DIR, names))``; rank r writes ``OUT_DIR/rank{r}.pt``,
rank 0 also ``OUT_DIR/one_process.pt``; a rank that fails writes its
traceback to ``OUT_DIR/rank{r}.err`` and exits 1 (it re-raises).
"""

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from stereo_tpu_torch.core.config import (MatchingConfig, MeshConfig,
                                          PipelineConfig)
from stereo_tpu_torch.parallel import (ShardedClassicalEngine,
                                       ShardedDnnEngine,
                                       ShardedSingleViewEngine,
                                       initialize_distributed, make_mesh)
from stereo_tpu_torch.parallel.mesh import Mesh
from stereo_tpu_torch.pipeline import DepthEstimationPipeline
from stereo_tpu_torch.synthesis import RightViewSynthesis

# tests/test_torch_parallel.py's configs.
CFG = dict(height=32, width=64, downscale_factor=2, min_disparity=0,
           max_disparity=15, cost_patch_radius=1, sad_patch_radius=2,
           threshold=5, small_mbm_radius=1, mid_mbm_radius=1,
           large_mbm_radius=2)
MIDDLEBURY = dict(height=48, width=96, downscale_factor=2, min_disparity=8,
                  max_disparity=23, cost_patch_radius=1, sad_patch_radius=3,
                  threshold=5, small_mbm_radius=1, mid_mbm_radius=2,
                  large_mbm_radius=3)

# name -> (kind, mesh, entries of "cpu" each rank lists, options).
CASES = {
    "classical_blockwise_141": ("classical", (1, 4, 1), (1, 1, 1, 1),
                                dict(impl="torch")),
    "classical_blockwise_114": ("classical", (1, 1, 4), (2, 1, 1, 1),
                                dict(impl="torch")),
    "classical_blockwise_221": ("classical", (2, 2, 1), (1, 1, 1, 1),
                                dict(impl="torch")),
    "classical_blockwise_222": ("classical", (2, 2, 2), (2, 2, 2, 2), {}),
    "classical_kernels_141": ("classical", (1, 4, 1), (1, 1, 1, 1), {}),
    "classical_kernels_221": ("classical", (2, 2, 1), (1, 1, 1, 1), {}),
    "middlebury_kernels_141": ("middlebury", (1, 4, 1), (1, 1, 1, 1), {}),
    "middlebury_blockwise_132": ("middlebury", (1, 3, 2), (2, 2, 1, 1), {}),
    "pipeline_122": ("pipeline", (1, 2, 2), None, {}),
    "gwcnet_split_221": ("gwcnet", (2, 2, 1), (2, 2, 2, 2), {}),
    "gwcnet_dealt_221": ("gwcnet", (2, 2, 1), (1, 1, 1, 1), dict(h=48)),
    "single_view_split_221": ("single_view", (2, 2, 1), (2, 2, 2, 2), {}),
}
# Row splits whose tile group spans ranks: refused at construction.
REFUSED = {"gwcnet_refused_121": ("gwcnet", (1, 2, 1), (1, 1, 1, 1)),
           "single_view_refused_121": ("single_view", (1, 2, 1),
                                       (1, 1, 1, 1))}
# make_mesh's global order: ranks list 2, 1, 1, 1 entries.
ORDER_COUNTS = (2, 1, 1, 1)


def integer_batch(cfg, n=2, seed=11, shift=5):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (n, 3, cfg["height"], cfg["width"]))
    left = torch.from_numpy(left.astype(np.float32))
    return left, torch.roll(left, -shift, dims=-1)


def real_batch(cfg, n=2, seed=3, shift=20):
    rng = np.random.default_rng(seed)
    left = torch.from_numpy(rng.uniform(
        0, 255, (n, 3, cfg["height"], cfg["width"])).astype(np.float32))
    return left, torch.roll(left, -shift, dims=-1)


def small_synthesis(h=64, w=96):
    """A seeded Deep3D at 128x256 / 32x64 (the same weights on every
    rank: ``RightViewSynthesis``'s seeded init)."""
    return RightViewSynthesis(output_shape=(h, w), seed=0,
                              model_full_shape=(128, 256),
                              model_down_shape=(32, 64), device="cpu")


def one_process_mesh(mc: MeshConfig) -> Mesh:
    """The same mesh in this process alone."""
    grid = np.empty(mc.num_devices, dtype=object)
    grid[:] = [torch.device("cpu")] * mc.num_devices
    return Mesh(grid.reshape(mc.data, mc.tile, mc.disp))


def run_case(name, across: bool):
    """Case ``name`` across the group (``across``) or on the same mesh in
    this process alone: a dict of its outputs."""
    kind, shape, entries, opts = CASES[name]
    mc = MeshConfig(*shape)

    def mesh_of(mc, entries):
        if across:
            return make_mesh(mc, ["cpu"] * entries[dist.get_rank()])
        return one_process_mesh(mc)

    if kind in ("classical", "middlebury"):
        base = CFG if kind == "classical" else MIDDLEBURY
        cfg = MatchingConfig(**dict(base, **opts))
        left, right = (integer_batch if kind == "classical"
                       else real_batch)(base, n=2 * mc.data)
        engine = ShardedClassicalEngine(cfg, mc, mesh=mesh_of(mc, entries))
        return dict(disparity=engine.compute_disparity_maps(left, right),
                    kernel_path=torch.tensor(engine.use_kernels))
    if kind == "pipeline":
        left, right = integer_batch(CFG)
        pcfg = PipelineConfig(image_shape=(32, 64), min_disparity=0,
                              max_disparity=15,
                              matching=MatchingConfig(**CFG), mesh=mc)
        if not across:
            engine = ShardedClassicalEngine(pcfg.matching_config(), mc,
                                            mesh=one_process_mesh(mc))
            maps = engine.compute_disparity_maps(left, right)
            return dict(batch=maps, single=maps[0])
        # The pipeline's own mesh: one "cpu" entry a rank (n / world).
        pipeline = DepthEstimationPipeline(pcfg, device="cpu")
        return dict(batch=pipeline.process_batch(left, right).disparity_map,
                    single=pipeline.process(left[0], right[0]).disparity_map)
    h = opts.get("h", 64)
    rng = np.random.default_rng(0)
    left = torch.from_numpy(rng.uniform(0, 255, (4, 3, h, 96)).astype(
        np.float32))
    if kind == "gwcnet":
        engine = ShardedDnnEngine("gwcnet", (h, 96), mc,
                                  mesh=mesh_of(mc, entries), max_disparity=16)
        return dict(disparity=engine.process_batch(
                        left, torch.roll(left, -3, dims=-1)),
                    single=engine.process(left[0], torch.roll(
                        left[0], -3, dims=-1)),
                    row_split=torch.tensor(engine.row_split))
    engine = ShardedSingleViewEngine(
        MatchingConfig(height=h, width=96, min_disparity=1, max_disparity=15),
        mc, mesh=mesh_of(mc, entries), synthesis=small_synthesis(h))
    disparity, right = engine.process_batch(left, return_right=True)
    return dict(disparity=disparity, right=right,
                row_split=torch.tensor(engine.row_split))


def refused(name):
    """Case ``name`` of :data:`REFUSED`: the ``ValueError``'s message."""
    kind, shape, entries = REFUSED[name]
    mc = MeshConfig(*shape)
    mesh = make_mesh(mc, ["cpu"] * entries[dist.get_rank()])
    try:
        if kind == "gwcnet":
            ShardedDnnEngine("gwcnet", (64, 96), mc, mesh=mesh,
                             max_disparity=16)
        else:
            ShardedSingleViewEngine(
                MatchingConfig(height=64, width=96, min_disparity=1,
                               max_disparity=15), mc, mesh=mesh,
                synthesis=small_synthesis())
    except ValueError as exc:
        return str(exc)
    return None


def mesh_order():
    """``make_mesh`` over ranks listing 2, 1, 1, 1 entries: the ranks of
    a (1, 5, 1) mesh, and the error for a sixth entry."""
    rank = dist.get_rank()
    mesh = make_mesh(MeshConfig(1, 5, 1), ["cpu"] * ORDER_COUNTS[rank])
    try:
        make_mesh(MeshConfig(data=6), ["cpu"] * ORDER_COUNTS[rank])
        error = None
    except RuntimeError as exc:
        error = str(exc)
    return dict(processes=mesh.processes.tolist(),
                local=[i for i in np.ndindex(*mesh.shape)
                       if mesh.is_local(i)],
                first_device=str(mesh.first_device), error=error)


def run(rank, world, init, out_dir, names):
    """One rank: every case of ``names`` across the group, then (rank 0)
    each case on the same mesh in this process alone."""
    torch.set_num_threads(1)
    try:
        initialize_distributed(init, world, rank, backend="gloo")
        initialize_distributed()        # no address: a no-op
        got = {"world_size": dist.get_world_size(),
               "mesh_order": mesh_order()}
        for name in names:
            got[name] = (run_case(name, across=True) if name in CASES
                         else refused(name))
        torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
        if rank == 0:
            torch.save({name: run_case(name, across=False)
                        for name in names if name in CASES},
                       os.path.join(out_dir, "one_process.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
