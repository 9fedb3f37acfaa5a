"""The ranks of ``tests/test_torch_multiprocess.py`` and
``tests/test_torch_multiprocess_train.py``, two groups of gloo ranks on
the CPU.

:func:`run`: each case of :data:`CASES` run by every rank of the group,
each rank saving what it received; before them each row-split funnel of
:data:`FUNNELS` split over two of the ranks, forward and
(:data:`GRAD_FUNNELS`) backward, splits across ranks that fail, in the
forward and in the backward, and a transport wait with no peer.

:func:`run_training`: Deep3D's sharded training step
(``parallel.train``) on each mesh of :data:`TRAIN_CASES`, with its data
groups or its tile groups across the ranks.

After the cases across the group, each rank leaves it and runs its share
of them (rank r: every world-th from r) on the same mesh in its process
alone, the one-process references.

A spawned child imports the module of the function it runs, so this one
imports only numpy, torch and the port (the test modules import JAX).
Run a group with ``stereo_tpu_torch.parallel.transport.spawn_ranks(run,
4, STORE, args=(OUT_DIR, names))``; rank r writes ``OUT_DIR/rank{r}.pt``
and ``OUT_DIR/one_process{r}.pt``; a rank that fails writes its traceback
to ``OUT_DIR/rank{r}.err`` and exits 1 (it re-raises).
"""

import hashlib
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from stereo_tpu_torch.core.config import (MatchingConfig, MeshConfig,
                                          PipelineConfig, TrainerConfig)
from stereo_tpu_torch.models import Deep3D, init_deep3d_params
from stereo_tpu_torch.parallel import (ShardedClassicalEngine,
                                       ShardedDnnEngine,
                                       ShardedSingleViewEngine,
                                       initialize_distributed, make_mesh)
from stereo_tpu_torch.ops import rows
from stereo_tpu_torch.parallel.mesh import Mesh
from stereo_tpu_torch.parallel import rows as parallel_rows
from stereo_tpu_torch.parallel import transport
from stereo_tpu_torch.parallel.rows import ShardThreads
from stereo_tpu_torch.parallel.train import ShardedTrainStep
from stereo_tpu_torch.parallel.transport import Line, Transport, spawn_ranks
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
    # Whole frames dealt over the tile devices: the engine's switch.
    "gwcnet_dealt_221": ("gwcnet", (2, 2, 1), (1, 1, 1, 1),
                         dict(h=48, row_split=False)),
    "single_view_split_221": ("single_view", (2, 2, 1), (2, 2, 2, 2), {}),
    # Row splits whose tile group spans ranks: the halo exchange crosses
    # them at every row-mixing layer.  (1,2,1) leaves ranks 2 and 3
    # outside the mesh; in the overlap case rank 1 holds a shard of both
    # groups, of which one spans ranks 0-1 and the other ranks 1-2.
    "gwcnet_split_121": ("gwcnet", (1, 2, 1), (1, 1, 1, 1), {}),
    "gwcnet_split_141": ("gwcnet", (1, 4, 1), (1, 1, 1, 1), {}),
    "gwcnet_split_221_overlap": ("gwcnet", (2, 2, 1), (1, 2, 1, 1), {}),
    # 24 rows a shard: the hourglasses gather across the ranks ahead of
    # their second stride, and narrow back.
    "gwcnet_split_121_h48": ("gwcnet", (1, 2, 1), (1, 1, 1, 1), dict(h=48)),
    "msnet2d_split_121": ("msnet2d", (1, 2, 1), (1, 1, 1, 1), dict(d=64)),
    "msnet3d_split_121": ("msnet3d", (1, 2, 1), (1, 1, 1, 1), {}),
    "single_view_split_121": ("single_view", (1, 2, 1), (1, 1, 1, 1), {}),
    "single_view_split_141": ("single_view", (1, 4, 1), (2, 1, 1, 1), {}),
}
NETWORKS = ("gwcnet", "msnet2d", "msnet3d")
# The row split's funnels, each split over ranks 0 and 1 (one shard each)
# and compared with the whole frame: name -> (input shape, function of a
# shard's rows, weight shape or None).
FUNNELS = {
    "halo_zeros": ((1, 2, 8, 5), lambda x, w: rows.halo(x, 1, 2), None),
    "halo_replicate": ((1, 2, 8, 5),
                       lambda x, w: rows.halo(x, 2, 1, edge="replicate"),
                       None),
    "halo_none": ((1, 2, 8, 5), lambda x, w: rows.halo(x, 1, 1, edge="none"),
                  None),
    "conv2d": ((2, 3, 8, 6), lambda x, w: rows.conv2d(x, w), (4, 3, 3, 3)),
    "interpolate": ((1, 2, 8, 6), lambda x, w: rows.interpolate(
        x, (x.shape[-2] * 4, 12), "bilinear"), None),
    "gather": ((1, 2, 8, 5), lambda x, w: rows.gather(x), None),
    "upsample_bilinear": ((1, 2, 8, 6),
                          lambda x, w: rows.upsample_bilinear(x, 2), None),
    # The rows received are dropped: their gradient is zeros.
    "halo_own_rows": ((1, 2, 8, 5),
                      lambda x, w: rows.halo(x, 1, 1)[..., 1:-1, :], None),
}
FUNNEL_RANKS = (0, 1)
# The funnels also run backward, from a seeded gradient of each shard's
# output rows (conv2d's edge zeros, upsample_bilinear's replicated).
GRAD_FUNNELS = ("conv2d", "gather", "halo_own_rows", "upsample_bilinear")
# Deep3D's training step, one frame a group, dropout on: name -> (mesh,
# "cpu" entries each rank lists).  (2,1,1) leaves ranks 2 and 3 outside
# the mesh: they take part in the gradients' all-gather and keep a replica.
# The others split rows over tile groups across ranks: (1,2,1) over ranks
# 0-1; (1,4,1) over all four, gathering before VggBlock_3's pool; (2,2,1)
# two groups, over ranks 0-1 and 2-3; (1,4,1) over ranks 0 and 1, two
# shards each, so a shard has a neighbour in its rank and one across
# (ranks 2 and 3 hold no entry); and (1,8,1) over all four, two shards
# each, 4 of the 32 down rows a shard, gathering before VggBlock_2's pool.
TRAIN_CASES = {"train_211": ((2, 1, 1), (1, 1, 1, 1)),
               "train_411": ((4, 1, 1), (1, 1, 1, 1)),
               "train_121": ((1, 2, 1), (1, 1, 1, 1)),
               "train_141": ((1, 4, 1), (1, 1, 1, 1)),
               "train_221": ((2, 2, 1), (1, 1, 1, 1)),
               "train_141_mixed": ((1, 4, 1), (2, 2, 1, 1)),
               "train_181": ((1, 8, 1), (2, 2, 2, 2))}
TRAIN_STEPS = 2
# make_mesh's global order: ranks list 2, 1, 1, 1 entries.
ORDER_COUNTS = (2, 1, 1, 1)
# The transport's bound in no_peer().
NO_PEER_TIMEOUT_S = 1.0


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
    this process alone: ``(outputs, halo)``, a dict of its outputs and
    what a row split's last batch call exchanged (None without one)."""
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
                    kernel_path=torch.tensor(engine.use_kernels)), None
    if kind == "pipeline":
        left, right = integer_batch(CFG)
        pcfg = PipelineConfig(image_shape=(32, 64), min_disparity=0,
                              max_disparity=15,
                              matching=MatchingConfig(**CFG), mesh=mc)
        if not across:
            engine = ShardedClassicalEngine(pcfg.matching_config(), mc,
                                            mesh=one_process_mesh(mc))
            maps = engine.compute_disparity_maps(left, right)
            return dict(batch=maps, single=maps[0]), None
        # The pipeline's own mesh: one "cpu" entry a rank (n / world).
        pipeline = DepthEstimationPipeline(pcfg, device="cpu")
        return dict(batch=pipeline.process_batch(left, right).disparity_map,
                    single=pipeline.process(left[0], right[0]).disparity_map
                    ), None
    h = opts.get("h", 64)
    rng = np.random.default_rng(0)
    left = torch.from_numpy(rng.uniform(0, 255, (4, 3, h, 96)).astype(
        np.float32))
    if kind in NETWORKS:
        engine = ShardedDnnEngine(kind, (h, 96), mc, mesh=mesh_of(mc, entries),
                                  max_disparity=opts.get("d", 16))
        engine.row_split = opts.get("row_split", engine.row_split)
        disparity = engine.process_batch(left, torch.roll(left, -3, dims=-1))
        halo = engine.halo
        return dict(disparity=disparity,
                    single=engine.process(left[0], torch.roll(
                        left[0], -3, dims=-1)),
                    row_split=torch.tensor(engine.row_split)), halo
    engine = ShardedSingleViewEngine(
        MatchingConfig(height=h, width=96, min_disparity=1, max_disparity=15),
        mc, mesh=mesh_of(mc, entries), synthesis=small_synthesis(h))
    disparity, right = engine.process_batch(left, return_right=True)
    return dict(disparity=disparity, right=right,
                row_split=torch.tensor(engine.row_split)), engine.halo


def train_case(name, across: bool) -> dict:
    """Case ``name`` of :data:`TRAIN_CASES` across the group or on the
    same mesh alone: each step's loss, a digest of the weights and Adam
    state afterwards (their bytes, in parameter order), whether this
    process's replicas are identical, whether the step split rows, and
    what the split exchanged in the last step (None without one)."""
    shape, entries = TRAIN_CASES[name]
    mc = MeshConfig(*shape)
    mesh = (make_mesh(mc, ["cpu"] * entries[dist.get_rank()]) if across
            else one_process_mesh(mc))
    model = Deep3D((32, 32), deconv_filters=(16,) * 5)
    init_deep3d_params(model, 0)
    step = ShardedTrainStep(model, TrainerConfig(), mesh, dropout=True,
                            seed=0)
    rng = np.random.default_rng(1)
    n = shape[0]
    left = torch.from_numpy(rng.uniform(0, 1, (n, 3, 128, 128)).astype(
        np.float32))
    right = torch.from_numpy(rng.uniform(0, 1, (n, 3, 128, 128)).astype(
        np.float32))
    down = torch.nn.functional.avg_pool2d(left, 4)
    try:
        losses = torch.stack([step.step(left, down, right)
                              for _ in range(TRAIN_STEPS)])
        state = [t for p in step.model.parameters()
                 for t in [p.detach()] + [
                     v for v in step.optimizers[next(iter(
                         step.replicas))].state[p].values()]]
        digest = hashlib.sha256(b"".join(
            t.contiguous().numpy().tobytes() for t in state)).hexdigest()
        return dict(losses=losses, digest=digest,
                    replicas_identical=step.replicas_identical(),
                    replicas=len(step.replicas),
                    row_split=step.layout.row_split, halo=step.halo)
    finally:
        step.close()


def funnel_input(name):
    """The seeded input and weight of funnel ``name``."""
    shape, _, wshape = FUNNELS[name]
    rng = np.random.default_rng(sorted(FUNNELS).index(name))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w = (None if wshape is None else torch.from_numpy(
        rng.standard_normal(wshape).astype(np.float32)))
    return x, w


def upstream(name, t, shape):
    """The seeded gradient of shard ``t``'s output (of ``shape``) of funnel
    ``name``."""
    rng = np.random.default_rng([GRAD_FUNNELS.index(name), t])
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def funnels():
    """Each funnel split over :data:`FUNNEL_RANKS`, one shard a rank: this
    rank's shard of the output and what the split exchanged across ranks
    (None on the other ranks).  Every rank makes the line (its process
    group is made collectively)."""
    line = Line(Transport(), FUNNEL_RANKS)
    rank = dist.get_rank()
    threads = ShardThreads()
    out = {}
    try:
        for name in sorted(FUNNELS):
            if rank not in FUNNEL_RANKS:
                out[name] = None
                continue
            x, w = funnel_input(name)
            t = FUNNEL_RANKS.index(rank)
            per = x.shape[-2] // len(FUNNEL_RANKS)
            split = [None] * len(FUNNEL_RANKS)
            split[t] = ("cpu", lambda: FUNNELS[name][1](
                x.narrow(-2, t * per, per), w))
            results, exchanges = threads.run([split], [line])
            ex = exchanges[0]
            out[name] = dict(rows=results[0][t], rounds=ex.rounds,
                             cross_rounds=ex.cross_rounds,
                             cross_bytes=ex.cross_bytes)
            if name in GRAD_FUNNELS:
                out[name].update(funnel_backward(threads, line, name, x, w))
        # The two ranks' shards exchange with different edge rules: the
        # keys' digests disagree.  Then rank 1's shard raises before its
        # first exchange, on a line of its own (a timed-out wait closes
        # the line's connections): rank 0 gives up after the timeout.
        out["out_of_step"] = failure(threads, line, lambda t, x: rows.halo(
            x, 1, 1, edge=("zeros", "replicate")[t]))
        out["failing_shard"] = failure(
            threads, Line(Transport(), FUNNEL_RANKS),
            lambda t, x: rows.halo(x, 1, 1) if t == 0 else 1 / 0,
            timeout_s=2.0)
        # The backward's twins: two runs in step, whose backward each rank
        # takes in another order (the keys' digests disagree); then a run
        # whose backward rank 1 never takes: rank 0 gives up after the
        # timeout.
        out["out_of_step_backward"] = backward_failure(
            threads, line, (0, 1) if rank == 0 else (1, 0))
        out["hung_backward"] = backward_failure(
            threads, Line(Transport(), FUNNEL_RANKS),
            (0,) if rank == 0 else (), timeout_s=2.0)
    finally:
        threads.close()
    return out


def funnel_backward(threads, line, name, x, w):
    """Funnel ``name`` split over :data:`FUNNEL_RANKS` under grad, then a
    backward from :func:`upstream`'s gradient of this rank's output rows,
    the loss tied to the run's last round: this shard's input gradient and
    what the backward exchanged."""
    t = FUNNEL_RANKS.index(dist.get_rank())
    per = x.shape[-2] // len(FUNNEL_RANKS)
    shard = x.narrow(-2, t * per, per).clone().requires_grad_()
    split = [None] * len(FUNNEL_RANKS)
    split[t] = ("cpu", lambda: FUNNELS[name][1](shard, w))
    with torch.enable_grad():
        results, exchanges = threads.run([split], [line])
        y, ex = results[0][t], exchanges[0]
        torch.autograd.backward(rows.tie(y, ex.token),
                                upstream(name, t, y.shape))
    return dict(grad=shard.grad, back_rounds=ex.back.rounds,
                back_cross_rounds=ex.back.cross_rounds,
                back_cross_bytes=ex.back.cross_bytes)


def backward_failure(threads, line, order, timeout_s=None):
    """Two runs of a halo (zeros, then replicated edges) split over
    :data:`FUNNEL_RANKS` under grad, in step, then this rank's backward of
    run ``order[0]`` (then ``order[1]``, ...): ``(error type, message,
    seconds)`` of what the backward raised, None on the other ranks or
    when nothing was raised."""
    rank = dist.get_rank()
    if rank not in FUNNEL_RANKS:
        return None
    t = FUNNEL_RANKS.index(rank)
    saved = parallel_rows.TURN_TIMEOUT_S
    if timeout_s is not None:
        parallel_rows.TURN_TIMEOUT_S = timeout_s
    try:
        runs = []
        for edge in ("zeros", "replicate"):
            x = torch.ones(1, 1, 4, 3, requires_grad=True)
            split = [None] * len(FUNNEL_RANKS)
            split[t] = ("cpu", lambda: rows.halo(x, 1, 1, edge=edge))
            with torch.enable_grad():
                results, exchanges = threads.run([split], [line])
            runs.append(rows.tie(results[0][t], exchanges[0].token))
    finally:
        parallel_rows.TURN_TIMEOUT_S = saved
    start = time.monotonic()
    try:
        for k in order:
            runs[k].sum().backward()
    except Exception as exc:
        return type(exc).__name__, str(exc), time.monotonic() - start
    return None


def failure(threads, line, fn, timeout_s=None):
    """``fn(t, rows)`` on shard t (this rank's) of a split over
    :data:`FUNNEL_RANKS`: ``(error type, message, seconds)`` of what the
    run raised, None on the other ranks or when nothing was raised."""
    rank = dist.get_rank()
    if rank not in FUNNEL_RANKS:
        return None
    t = FUNNEL_RANKS.index(rank)
    split = [None] * len(FUNNEL_RANKS)
    split[t] = ("cpu", lambda: fn(t, torch.ones(1, 1, 4, 3)))
    saved = parallel_rows.TURN_TIMEOUT_S
    if timeout_s is not None:
        parallel_rows.TURN_TIMEOUT_S = timeout_s
    start = time.monotonic()
    try:
        threads.run([split], [line])
    except Exception as exc:
        return type(exc).__name__, str(exc), time.monotonic() - start
    finally:
        parallel_rows.TURN_TIMEOUT_S = saved
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


def no_peer():
    """Rank 0 fetches its neighbour's rows on a line of ranks 0 and 1 that
    rank 1 never serves, under the transport's own bound
    (``transport.TIMEOUT_S``, made :data:`NO_PEER_TIMEOUT_S`): ``(error
    type, message, seconds)`` of what it raised, None on the other ranks
    or when nothing was raised.  Every rank makes the line (collective)."""
    line = Line(Transport(), FUNNEL_RANKS)
    if dist.get_rank() != 0:
        return None
    saved = transport.TIMEOUT_S
    transport.TIMEOUT_S = NO_PEER_TIMEOUT_S
    start = time.monotonic()
    try:
        line.ring_fetch([torch.ones(2), None], [(1, lambda x: x)],
                        wrap=False)
    except RuntimeError as exc:
        return type(exc).__name__, str(exc), time.monotonic() - start
    finally:
        transport.TIMEOUT_S = saved
    return None


def run(rank, world, init, out_dir, names):
    """One rank of the group of :data:`CASES`: the funnels, a wait with no
    peer and every case of ``names`` across the group, then a share of
    those cases (rank r: every world-th from r) on the same mesh in this
    process alone."""
    def across():
        got = {"world_size": dist.get_world_size(),
               "mesh_order": mesh_order(), "funnels": funnels(),
               "no_peer": no_peer(), "halo": {}}
        for name in names:
            got[name], got["halo"][name] = run_case(name, across=True)
        return got

    def alone(share):
        got = {"halo": {}}
        for name in share:
            got[name], got["halo"][name] = run_case(name, across=False)
        return got

    in_group(rank, world, init, out_dir, names, across, alone)


def run_training(rank, world, init, out_dir, names):
    """One rank of the group of :data:`TRAIN_CASES`: every case of
    ``names`` across the group, then a share of them alone, as
    :func:`run`."""
    in_group(rank, world, init, out_dir, names,
             lambda: {name: train_case(name, across=True) for name in names},
             lambda share: {name: train_case(name, across=False)
                            for name in share})


def in_group(rank, world, init, out_dir, names, across, alone):
    """Join the gloo group, save ``across()`` to ``rank{rank}.pt``, leave
    the group, then save ``alone(share)`` of this rank's share of
    ``names`` to ``one_process{rank}.pt`` (each rank on a core of its
    own)."""
    torch.set_num_threads(1)
    try:
        initialize_distributed(init, world, rank, backend="gloo")
        initialize_distributed()        # no address: a no-op
        torch.save(across(), os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
        torch.save(alone(sorted(names)[rank::world]),
                   os.path.join(out_dir, f"one_process{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_group(target, names, world, out_dir, timeout_s):
    """``target``'s group of ``world`` ranks over ``names``, spawned on a
    store in ``out_dir`` and joined within ``timeout_s``: (each rank's
    results, the one-process results of every rank's share, merged).  A
    rank that failed fails it, with every rank's traceback."""
    codes = spawn_ranks(target, world, os.path.join(out_dir, "store"),
                        args=(out_dir, names), timeout_s=timeout_s)
    errors = {}
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors[r] = f.read()
    assert codes == [0] * world, (codes, errors)
    alone = {"halo": {}}
    for r in range(world):
        part = torch.load(os.path.join(out_dir, f"one_process{r}.pt"),
                          weights_only=False)
        alone["halo"].update(part.pop("halo", {}))
        alone.update(part)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)], alone
