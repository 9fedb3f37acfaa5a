"""The port's optimizers, schedules and checkpoints against the JAX
package: one step after another from identical gradients for each
optimizer (Adam with coupled L2 and StepLR; AdamW; a global-norm clip
then AdamW on the warmup-cosine schedule) against optax; the schedules'
values; npz files written by either package loaded by the other, with
equal forwards."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stereo_tpu.core.config import TrainerConfig as JaxTrainerConfig
from stereo_tpu.models import Deep3D as JaxDeep3D
from stereo_tpu.models import build_stereo_model as jax_build_stereo_model
from stereo_tpu.models import load_npz_meta as jax_load_npz_meta
from stereo_tpu.models import load_params_npz as jax_load_params_npz
from stereo_tpu.models import save_params_npz as jax_save_params_npz
from stereo_tpu.train.trainer import make_optimizer as jax_make_optimizer
from stereo_tpu.train.trainer import step_lr_for_epoch as jax_step_lr

from stereo_tpu_torch.core.config import TrainerConfig
from stereo_tpu_torch.models import (Deep3D, build_stereo_model,
                                     flax_arrays_from_state_dict,
                                     init_params, load_deep3d_npz,
                                     load_npz_meta, load_or_init_params,
                                     load_params_npz, save_params_npz)
from stereo_tpu_torch.models.layers import BatchNorm
from stereo_tpu_torch.synthesis import RightViewSynthesis
from stereo_tpu_torch.train import SyntheticDeep3DTrainer
from stereo_tpu_torch.train.stereo_trainer import clip_global_norm
from stereo_tpu_torch.train.synthetic import warmup_cosine_decay_schedule
from stereo_tpu_torch.train.trainer import (make_optimizer,
                                            set_learning_rate,
                                            step_lr_for_epoch)

import torch_threads

torch_threads.take_worker_share()

SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}


def nest(flat):
    out = {}
    for key, arr in flat.items():
        parts = re.findall(r"\['([^']+)'\]", key)
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(arr)
    return out


def run_both(torch_opt_of, optax_tx, lrs, grad_scale=1.0, clip=None):
    """Apply the same seeded gradients for ``len(lrs)`` steps with a torch
    optimizer (``lr`` set before each step, an optional global-norm clip)
    and an optax transformation; returns both parameter histories."""
    rng = np.random.default_rng(0)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in
            SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * grad_scale * (1 + i)).astype(
        np.float32) for k, s in SHAPES.items()} for i in range(len(lrs))]
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = torch_opt_of(list(params.values()))
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = optax_tx.init(jparams)
    got, want = [], []
    for step, (lr, g) in enumerate(zip(lrs, grads)):
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        if clip is not None:
            clip_global_norm(params.values(), clip)
        if lr is not None:
            set_learning_rate(opt, lr)
            if hasattr(state, "hyperparams"):
                state.hyperparams["learning_rate"] = jnp.asarray(
                    lr, jnp.float32)
        opt.step()
        updates, state = optax_tx.update(
            {k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        got.append({k: p.detach().numpy().copy() for k, p in params.items()})
        want.append({k: np.asarray(v) for k, v in jparams.items()})
    return got, want


def assert_histories_close(got, want):
    """Float32 updates summed in another order: within 2e-6 absolute (the
    parameters are O(1), each step moves them by about the rate)."""
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=2e-6)


def test_coupled_adam_with_step_lr_matches_optax():
    """``make_optimizer`` (torch Adam, coupled L2) against the JAX
    package's optax chain, with the StepLR rate changing at an epoch
    boundary."""
    jcfg = JaxTrainerConfig(learning_rate=1e-2, weight_decay=1e-2,
                            step_size=2, gamma=0.1)
    cfg = TrainerConfig(learning_rate=1e-2, weight_decay=1e-2, step_size=2,
                        gamma=0.1)
    lrs = [step_lr_for_epoch(cfg, e) for e in (0, 1, 2, 3)]
    assert lrs == pytest.approx([jax_step_lr(jcfg, e) for e in (0, 1, 2, 3)])
    got, want = run_both(lambda p: make_optimizer(p, cfg),
                         jax_make_optimizer(jcfg), lrs)
    assert_histories_close(got, want)


def test_adamw_matches_optax():
    """``StereoTrainer``'s optimizer: torch AdamW against ``optax.adamw``
    (decoupled decay)."""
    cfg = TrainerConfig(learning_rate=1e-2, weight_decay=0.1)
    got, want = run_both(
        lambda p: torch.optim.AdamW(p, lr=cfg.learning_rate,
                                    betas=(cfg.momentum, 0.999), eps=1e-8,
                                    weight_decay=cfg.weight_decay),
        optax.adamw(cfg.learning_rate, b1=cfg.momentum, b2=0.999,
                    weight_decay=cfg.weight_decay), [None] * 4)
    assert_histories_close(got, want)


def test_clip_and_warmup_cosine_adamw_matches_optax():
    """``SyntheticStereoTrainer``'s update: a global-norm clip at 5, then
    AdamW on the warmup-cosine rate, against ``optax.chain``; the
    gradients' norms (about 5-20) put the clip on and off across steps."""
    lr = 1e-2
    schedule = warmup_cosine_decay_schedule(lr * 0.05, lr, 2, 6, lr * 0.02)
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(lr * 0.05, lr, 2, 6, lr * 0.02),
        weight_decay=1e-4))
    got, want = run_both(
        lambda p: torch.optim.AdamW(p, lr=schedule(0), betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=1e-4),
        tx, [schedule(s) for s in range(8)], grad_scale=1.2, clip=5.0)
    assert_histories_close(got, want)


@pytest.mark.parametrize("args", [(5e-5, 1e-3, 100, 2000, 2e-5),
                                  (1e-5, 2e-4, 100, 15000, 1e-5),
                                  (0.0, 1.0, 1, 3, 0.0)])
def test_warmup_cosine_schedule_equals_optax(args):
    """Every step of the horizon and past it (the boundaries: step 0, the
    end of the warmup, the end of the decay), within float32 rounding."""
    ours = warmup_cosine_decay_schedule(*args)
    theirs = optax.warmup_cosine_decay_schedule(*args)
    steps = sorted(set(range(0, args[3] + 3, max(1, args[3] // 400)))
                   | {0, args[2] - 1, args[2], args[2] + 1, args[3] - 1,
                      args[3], args[3] + 1})
    got = np.array([ours(s) for s in steps])
    want = np.array([float(theirs(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-12)
    with pytest.raises(ValueError):
        warmup_cosine_decay_schedule(1e-5, 1e-4, 100, 100)


# --- npz checkpoints ---------------------------------------------------------

def seeded_stereo(name, seed=1):
    model = build_stereo_model(name, 16)
    init_params(model, seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return model.eval()


def stereo_pair(seed=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, 3, 32, 64)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("name", ["gwcnet", "msnet3d"])
def test_port_npz_loads_in_jax_with_equal_forward(tmp_path, name):
    """The port's export (parameters float16, ``batch_stats`` float32, the
    JAX key names) read by ``stereo_tpu.models.load_params_npz``: JAX's
    eval forward on it equals the port's on the same file within 1e-3 px
    (the networks' contract; seen at 1e-5)."""
    path = str(tmp_path / f"{name}.npz")
    save_params_npz(seeded_stereo(name), path)
    with np.load(path) as data:
        kinds = {k: data[k].dtype for k in data.files}
    assert all((v == np.float32) == k.startswith("['batch_stats']")
               for k, v in kinds.items())
    variables = jax_load_params_npz(path)
    assert set(variables) == {"params", "batch_stats"}
    left, right = stereo_pair()
    want = np.asarray(jax_build_stereo_model(name, 16).apply(
        variables, left, right, train=False))
    model = build_stereo_model(name, 16)
    assert load_or_init_params(model, name, checkpoint_dir=path) == path
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(left),
                           torch.from_numpy(right)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_jax_npz_loads_in_the_port(tmp_path):
    """A file JAX's ``save_params_npz`` wrote: the port reads the same
    values (``load_params_npz``), its state_dict converts back to them,
    and the two files hold the same keys and dtypes."""
    model = seeded_stereo("msnet2d", seed=5)
    arrays = flax_arrays_from_state_dict(model)
    jax_path, port_path = str(tmp_path / "jax.npz"), str(tmp_path / "p.npz")
    jax_save_params_npz(nest(arrays), jax_path)
    save_params_npz(model, port_path)
    theirs, ours = load_params_npz(jax_path), load_params_npz(port_path)
    assert set(theirs) == set(ours) == set(arrays)
    for key in arrays:
        np.testing.assert_array_equal(ours[key], theirs[key])
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert {k: a[k].dtype for k in a.files} == {k: b[k].dtype
                                                    for k in b.files}
    loaded = build_stereo_model("msnet2d", 16)
    assert load_or_init_params(loaded, "msnet2d",
                               checkpoint_dir=jax_path) == jax_path
    for key, value in flax_arrays_from_state_dict(loaded).items():
        np.testing.assert_array_equal(value, theirs[key])


def test_deep3d_export_loads_in_jax_and_the_synthesis(tmp_path):
    """Deep3D trained at 128x256: its export carries the training size in
    ``meta`` (both packages read it), JAX's probability volume on it
    equals the port's within 2e-5, and ``RightViewSynthesis`` adopts it."""
    trainer = SyntheticDeep3DTrainer(height=128, width=256, batch_size=1,
                                     chunk=1, device="cpu")
    path = str(tmp_path / "deep3d.npz")
    trainer.export(path)
    meta = load_npz_meta(path)
    assert {k: v.tolist() for k, v in meta.items()} == {
        k: v.tolist() for k, v in jax_load_npz_meta(path).items()} == {
        "full_shape": [128, 256], "down_shape": [32, 64],
        "prob_volume_scale": 4}
    rng = np.random.default_rng(3)
    down = rng.uniform(0, 1, (1, 3, 32, 64)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: JaxDeep3D().apply(
        v, x, method=JaxDeep3D.prob_volume_low))(jax_load_params_npz(path),
                                                 down))
    state, _ = load_deep3d_npz(path)
    model = Deep3D((32, 64))
    model.load_state_dict(state)
    with torch.no_grad():
        got = model.eval().prob_volume_low(torch.from_numpy(down)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    synthesis = RightViewSynthesis(output_shape=(128, 256),
                                   checkpoint_dir=path,
                                   ff_weights_dtype="float32", device="cpu")
    assert synthesis.model_full_shape == (128, 256)
    view = synthesis.process(torch.from_numpy(
        rng.uniform(0, 255, (3, 128, 256)).astype(np.float32)))
    assert view.shape == (3, 128, 256) and bool(torch.isfinite(view).all())
