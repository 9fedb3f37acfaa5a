"""Deep3D's sharded training step (``stereo_tpu_torch/parallel/train.py``,
the port of ``__graft_entry__.dryrun_multichip`` (b)) on the CPU, at the
graft entry's 128x128 / 32x32 views, batch 2 (3 where ``tile`` folds
into the batch), the deconvolution branches 16 filters wide.

Against the port's single-device ``Trainer`` on the whole batch, two
steps on meshes (2,1,1), (1,2,1), (2,2,1), (1,4,1) and (1,3,1) (whose
``tile`` folds into the batch), dropout off and on: each step's loss
within rtol 1e-6 and its gradients within 1e-5 of each array's largest
entry, and the weights after both within 1e-5 of each array's largest
entry.  These run in float64: in float32 the shards' convolutions (a
frame each, or a band of rows) round otherwise than the whole batch's,
and a pre-activation or a pooling window within that rounding of a tie
flips its ReLU or its max (seen at (1,3,1): one array's gradient then
far outside 1e-5 at the second step).  The global branch computes in
float32 in training mode either way (``models/deep3d.py``), whose
rounding is what remains.  Against JAX's GSPMD step in float32 on virtual devices of
``tests/conftest.py`` (``jax.jit(jax.value_and_grad(...))`` with the graft
entry's shardings, dropout off through the unfused
``synthesize_with_probabilities``), the batch over 4 devices and the rows
over 2: the loss within rtol 1e-4 and the gradients within 2e-3 of each
array's largest entry, as ``tests/test_torch_train_models.py`` holds
Deep3D's single device.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from stereo_tpu.core.config import MeshConfig as JaxMeshConfig
from stereo_tpu.models import Deep3D as JaxDeep3D
from stereo_tpu.parallel import make_mesh as jax_make_mesh
from test_torch_train_models import (assert_close_rel, flat, grads_as_flax,
                                     nest)

from stereo_tpu_torch.core.config import MeshConfig, TrainerConfig
from stereo_tpu_torch.models import (Deep3D, flax_arrays_from_state_dict,
                                     init_deep3d_params)
from stereo_tpu_torch.ops import rows
from stereo_tpu_torch.ops.shift_stack import weighted_shift_sum
from stereo_tpu_torch.parallel import make_mesh
from stereo_tpu_torch.parallel.rows import ShardThreads
from stereo_tpu_torch.parallel.train import (ShardedTrainStep, alias,
                                             train_layout)
from stereo_tpu_torch.train.trainer import Trainer

FULL, DOWN = (128, 128), (32, 32)
FILTERS = (16, 16, 16, 16, 16)
MESHES = [(2, 1, 1), (1, 2, 1), (2, 2, 1), (1, 4, 1), (1, 3, 1)]
STEPS = 2


def seeded_model(dtype=torch.float64) -> Deep3D:
    model = Deep3D(DOWN, deconv_filters=FILTERS)
    init_deep3d_params(model, 0)
    return model.to(dtype)


def batch_of(n: int, dtype=torch.float64, seed=0):
    """``(left_full, left_down, right_full)`` in 0..1: seeded views, the
    down view their 4x4 mean."""
    rng = np.random.default_rng(seed + n)
    left = torch.from_numpy(rng.uniform(0, 1, (n, 3, *FULL))).to(dtype)
    right = torch.from_numpy(rng.uniform(0, 1, (n, 3, *FULL))).to(dtype)
    return left, torch.nn.functional.avg_pool2d(left, 4), right


def batch_size(mesh) -> int:
    """Batch 2, or 3 where ``tile`` 3 folds into the batch."""
    return 3 if FULL[0] % mesh[1] else 2


def grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def weights(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def assert_arrays_close(got: dict, want: dict, rtol: float, label):
    """Every array within ``rtol`` of its own largest magnitude."""
    assert got.keys() == want.keys()
    for key in want:
        scale = max(float(want[key].abs().max()), 1e-30)
        err = float((got[key] - want[key]).abs().max())
        assert err <= rtol * scale, (label, key, err, scale)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its float64 steps launch many
    small parallel regions, and beside the suite's other workers every
    region's threads wait on each other, many times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def single_device():
    """The single device's ``STEPS`` steps per (batch, dropout): each
    step's loss and gradients, and the weights after the last."""
    runs = {}

    def get(n, dropout):
        if (n, dropout) not in runs:
            trainer = Trainer(seeded_model(), TrainerConfig(),
                              state_dict=seeded_model().state_dict(),
                              device="cpu", dropout=dropout)
            trainer.generator.manual_seed(0)
            steps = []
            for _ in range(STEPS):
                loss = trainer.train_step(*batch_of(n))
                steps.append((float(loss), grads(trainer.model)))
            runs[n, dropout] = steps, weights(trainer.model)
        return runs[n, dropout]
    return get


def sharded(mesh, dropout, model=None):
    mc = MeshConfig(*mesh)
    return ShardedTrainStep(model if model is not None else seeded_model(),
                            TrainerConfig(),
                            make_mesh(mc, ["cpu"] * mc.num_devices),
                            dropout=dropout, seed=0)


@pytest.mark.parametrize("dropout", [False, True], ids=["no_dropout",
                                                        "dropout"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "".join(map(str, m)))
def test_sharded_step_matches_single_device(single_device, mesh, dropout):
    n = batch_size(mesh)
    want_steps, want_weights = single_device(n, dropout)
    step = sharded(mesh, dropout)
    try:
        for s, (want_loss, want_grads) in enumerate(want_steps):
            loss = step.step(*batch_of(n))
            assert loss.shape == () and loss.dtype == torch.float64
            np.testing.assert_allclose(float(loss), want_loss, rtol=1e-6)
            assert_arrays_close(grads(step.model), want_grads, 1e-5,
                                (mesh, dropout, s))
            assert step.replicas_identical()
        assert_arrays_close(weights(step.model), want_weights, 1e-5,
                            (mesh, dropout, "weights"))
        layout = step.layout
        assert layout.row_split == (mesh[1] > 1 and mesh != (1, 3, 1))
        assert len(step.replicas) == 1       # a mesh of one device
    finally:
        step.close()


def test_layout_follows_the_graft_entry():
    """Rows over ``tile`` where it divides the full rows, each group's
    frames in mesh order; else ``tile`` in the batch, (data, tile, disp)
    major to minor, as ``P(("data", "tile", "disp"))`` orders it."""
    split = train_layout((2, 2, 1), 4, FULL, DOWN)
    assert split.row_split
    assert split.frames == ((0, 2), (0, 2), (2, 4), (2, 4))
    assert split.tile_of == (0, 1, 0, 1)
    assert split.groups == ((0, 1), (2, 3))
    folded = train_layout((1, 3, 2), 6, FULL, DOWN)
    assert not folded.row_split
    assert folded.frames == tuple((k, k + 1) for k in range(6))
    assert folded.groups == tuple((k,) for k in range(6))
    with pytest.raises(ValueError, match="not divisible"):
        train_layout((2, 1, 1), 3, FULL, DOWN)


def test_row_split_jax_takes_and_the_port_does_not_raises():
    """At tile 8 JAX splits the 128 full rows; a shard would hold 4 of the
    32 down rows, not a multiple of ``DEEP3D_ROW_STRIDE``: the step raises
    and names the heights that split, rather than take another batch
    group."""
    step = sharded((1, 8, 1), False)
    try:
        with pytest.raises(ValueError, match=r"multiple of 64 \(down 64, "
                                             r"128, 192.*full 256"):
            step.step(*batch_of(1))
    finally:
        step.close()
    with pytest.raises(ValueError, match="4x the down view"):
        train_layout((1, 2, 1), 1, (128, 128), (16, 16))


def test_tile_group_across_ranks_raises():
    """A mesh whose tile group lies on two ranks (its entries' ranks
    recorded as ``make_mesh`` records them under a process group; this
    process rank 0): the rows received across ranks carry no gradient,
    so the step refuses before any work."""
    mc = MeshConfig(1, 2, 1)
    mesh = make_mesh(mc, ["cpu"] * 2)
    mesh.processes = np.array([[[0], [1]]])
    mesh.local_devices = [torch.device("cpu")]
    mesh.transport = types.SimpleNamespace(rank=0)
    step = ShardedTrainStep(seeded_model(), TrainerConfig(), mesh,
                            dropout=False)
    try:
        with pytest.raises(ValueError, match="spans processes"):
            step.step(*batch_of(1))
    finally:
        step.close()


def test_cuda_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    mc = MeshConfig(data=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedTrainStep(seeded_model(), TrainerConfig(),
                         make_mesh(mc, ["cuda"] * 2))


def split_run(model, tile, full, down, right, count):
    """Each shard's loss on its rows of the batch, in a row split over
    ``tile`` shards, each with parameters of its own
    (``parallel.train.alias``), one backward over all: each shard's
    gradients."""
    shards = [alias(model) for _ in range(tile)]

    def loss(t):
        def part(x):
            per = x.shape[-2] // tile
            return x.narrow(-2, t * per, per)
        pred = shards[t](part(full), part(down))
        return (pred - part(right)).abs().sum() / count

    threads = ShardThreads()
    try:
        with torch.enable_grad():
            results, _ = threads.run([[("cpu", lambda t=t: loss(t))
                                       for t in range(tile)]])
            torch.autograd.backward(results[0])
    finally:
        threads.close()
    return [grads(m) for m in shards]


# The layers each tile runs on the gathered frame (models/deep3d.py): at
# tile 2 a shard's 16 down rows pool whole through VggBlock_3 and gather
# before VggBlock_4's pool, at tile 4 its 8 rows before VggBlock_3's; the
# global branch always runs gathered.
GATHERED = {2: ("DeconvBranch_4", "FeedForwardBranch_0"),
            4: ("DeconvBranch_3", "VggBlock_4", "DeconvBranch_4",
                "FeedForwardBranch_0")}


@pytest.mark.parametrize("tile", [2, 4])
def test_gathered_levels_sum_their_gradient_over_shards(tile):
    """The levels run on the gathered frame on every shard, their outputs
    narrowed to the shard's rows: each shard's gradient of their
    parameters is its own rows' part (none is the whole, and none is
    zero), and the shards' sum is the whole frame's, as for every other
    parameter."""
    model = seeded_model()
    full, down, right = batch_of(1)
    per_shard = split_run(model, tile, full, down, right, right.numel())
    pred = model.train()(full, down)
    ((pred - right).abs().sum() / right.numel()).backward()
    want = grads(model)
    total = {k: sum(g[k] for g in per_shard) for k in want}
    assert_arrays_close(total, want, 1e-5, tile)
    gathered = [k for k in want
                if k.split(".")[1].startswith(GATHERED[tile])
                and k.endswith("weight")]
    assert gathered
    for k in gathered:
        scale = float(want[k].abs().max())
        for g in per_shard:
            part = float((g[k] - want[k]).abs().max())
            assert float(g[k].abs().max()) > 0 and part > 1e-3 * scale, k


def test_blend_is_row_local():
    """``weighted_shift_sum`` shifts along columns only: the blend of
    row bands, joined, is the whole frame's bit for bit, and so is its
    gradient."""
    rng = np.random.default_rng(5)
    prob = torch.softmax(torch.from_numpy(rng.standard_normal(
        (2, 65, 16, 24))), dim=1).requires_grad_()
    view = torch.from_numpy(rng.uniform(0, 1, (2, 3, 16, 24))
                            ).requires_grad_()
    whole = weighted_shift_sum(prob, view)
    bands = torch.cat([weighted_shift_sum(prob[..., r:r + 4, :],
                                          view[..., r:r + 4, :])
                       for r in range(0, 16, 4)], dim=-2)
    assert torch.equal(bands, whole)
    weight = torch.from_numpy(rng.standard_normal(whole.shape))
    want = torch.autograd.grad((whole * weight).sum(), (prob, view))
    got = torch.autograd.grad((bands * weight).sum(), (prob, view))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_upsample_bilinear_matches_interpolate(s, dtype):
    """Deep3D's training upsample (slices and weighted sums, a backward
    without atomics) against ``F.interpolate``'s bilinear resize, values
    and gradients, within a rounding of the top row's summed weights."""
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 5, 6, 7))).to(dtype)
    weight = torch.from_numpy(rng.standard_normal((2, 5, 6 * s, 7 * s))
                              ).to(dtype)
    outs, grads_ = [], []
    for fn in (lambda v: rows.upsample_bilinear(v, s),
               lambda v: torch.nn.functional.interpolate(
                   v, scale_factor=s, mode="bilinear", align_corners=False)):
        v = x.clone().requires_grad_()
        out = fn(v)
        (out * weight).sum().backward()
        outs.append(out.detach())
        grads_.append(v.grad)
    tol = 1e-6 if dtype == torch.float32 else 1e-14
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=tol)
    torch.testing.assert_close(grads_[0], grads_[1], rtol=0, atol=10 * tol)


def test_training_upsample_takes_its_halo_in_a_split():
    """``disparity_probabilities`` inside a row split takes one volume
    row of each neighbour (``ops.rows.upsample_bilinear``): the shards'
    rows, joined, are the whole frame's."""
    model = seeded_model()
    _, down, _ = batch_of(1)
    with torch.no_grad():
        want = model.disparity_probabilities(down)
        threads = ShardThreads()
        try:
            results, _ = threads.run([[("cpu", lambda t=t: (
                model.disparity_probabilities(down[..., 8 * t:8 * t + 8, :]),
                rows.current().count)) for t in range(4)]])
        finally:
            threads.close()
    got = torch.cat([r[0] for r in results[0]], dim=-2)
    assert [r[1] for r in results[0]] == [4] * 4
    # The global branch computes in float32 (models/deep3d.py).
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# (mesh, batch): the batch over data x disp on 4 devices, and the rows over
# tile on 2.  JAX's GSPMD step itself goes wrong where rows split over tile
# on 4 devices ((2,2,1), (1,2,2), (1,4,1)): some gradients come out 2x
# (4x on 8 devices) those of its own unsharded step, at 128x128, 128x256
# and 256x256 (tests/jax_gspmd_train_check.py prints the ratios); the port
# is held to JAX's unsharded step there through the single device.
# The rows case takes over 30 s to compile cold on one CPU worker.
JAX_CASES = [((2, 1, 2), 4),
             pytest.param((1, 2, 1), 2, marks=pytest.mark.slow)]


@pytest.mark.parametrize("mesh,n", JAX_CASES,
                         ids=lambda v: "".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_sharded_step_matches_jax_gspmd_step(mesh, n):
    """The port's step against JAX's GSPMD value and gradient on the same
    mesh of virtual devices, with the graft entry's shardings, float32,
    dropout off.  JAX runs first: its arrays may share memory with the
    weights, which the port's Adam step then updates in place."""
    model = seeded_model(torch.float32)
    params = nest(flax_arrays_from_state_dict(model))["params"]
    left, down, right = (x.float() for x in batch_of(n, seed=3))
    jmodel = JaxDeep3D(deconv_filters=FILTERS)
    jmesh = jax_make_mesh(JaxMeshConfig(*mesh),
                          jax.devices()[:int(np.prod(mesh))])
    batch = NamedSharding(jmesh, P(("data", "disp"), None, "tile", None))
    replicated = NamedSharding(jmesh, P())

    def loss_fn(p, lf, ld, rf):
        pred = jmodel.apply({"params": p}, lf, ld, train=False,
                            method=JaxDeep3D.synthesize_with_probabilities)[0]
        return jnp.abs(pred - rf).mean()

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn),
                             in_shardings=(replicated, batch, batch, batch))
    want_loss, want_grads = value_and_grad(
        params, *(jax.device_put(jnp.asarray(x.numpy()), batch)
                  for x in (left, down, right)))
    want_loss = float(want_loss)
    want_grads = flat({"params": want_grads})

    step = sharded(mesh, False, model)
    try:
        loss = step.step(left, down, right)
        got = grads_as_flax(step.model)
        assert step.layout.row_split == (mesh[1] > 1)
    finally:
        step.close()
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-4)
    assert_close_rel(got, want_grads, 2e-3, ("sharded deep3d grads", mesh))
