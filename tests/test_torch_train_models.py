"""Training mode of the port's networks against the JAX package's
``train=True`` applies, on the same seeded weights and inputs: forward
outputs, losses, gradients and the new BatchNorm statistics of GwcNet,
MSNet2D and MSNet3D; Deep3D's synthetic-training loss and gradients with
dropout off against JAX's unfused (differentiable) path; and the kernel
wrappers' refusal to cut a gradient.

Weights start in the port (``init_params``, running statistics drawn at
random), go to JAX through ``flax_arrays_from_state_dict`` (the inverse of
the checkpoint loader) and are compared in the Flax layout.
"""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from stereo_tpu.models import Deep3D as JaxDeep3D
from stereo_tpu.models import build_stereo_model as jax_build_stereo_model
from stereo_tpu.models import gwcnet_loss as jax_gwcnet_loss
from stereo_tpu.models import msnet_loss as jax_msnet_loss

from stereo_tpu_torch.models import (Deep3D, build_stereo_model,
                                     flax_arrays_from_state_dict, gwcnet_loss,
                                     init_deep3d_params, init_params,
                                     msnet_loss)
from stereo_tpu_torch.models.layers import BatchNorm
from stereo_tpu_torch.ops.cuda import launch
from stereo_tpu_torch.train.synthetic import SyntheticDeep3DTrainer

import torch_threads

torch_threads.take_worker_share()

LOSSES = {"gwcnet": (gwcnet_loss, jax_gwcnet_loss, 4),
          "msnet2d": (msnet_loss, jax_msnet_loss, 3),
          "msnet3d": (msnet_loss, jax_msnet_loss, 3)}


def nest(flat):
    """``"['params']['a']['kernel']"`` keyed arrays -> nested dict."""
    out = {}
    for key, arr in flat.items():
        parts = re.findall(r"\['([^']+)'\]", key)
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(arr)
    return out


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def grads_as_flax(model):
    """The port's gradients in the Flax layout (parameters only)."""
    shadow = copy.deepcopy(model)
    with torch.no_grad():
        for name, p in shadow.named_parameters():
            p.copy_(dict(model.named_parameters())[name].grad)
    return {k: v for k, v in flax_arrays_from_state_dict(shadow).items()
            if k.startswith("['params']")}


def assert_close_rel(got, want, rtol, label, floor=0.0):
    """Every array within ``rtol`` of its own largest magnitude, or within
    ``floor`` (for arrays whose exact value is 0, such as the gradient of a
    bias that a training-mode BatchNorm removes again)."""
    assert set(got) == set(want), label
    for key in want:
        scale = max(float(np.abs(want[key]).max()), 1e-12)
        err = float(np.abs(got[key] - want[key]).max())
        assert err <= max(rtol * scale, floor), (label, key, err, scale)


def seeded_stereo(name):
    """``name`` at disparity 16 with seeded weights and running statistics
    drawn away from (0, 1), and its weights in the Flax layout."""
    model = build_stereo_model(name, 16)
    init_params(model, 3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return model, flax_arrays_from_state_dict(model)


def stereo_batch(dtype):
    rng = np.random.default_rng(5)
    left = rng.normal(size=(2, 3, 32, 64)).astype(dtype)
    right = rng.normal(size=(2, 3, 32, 64)).astype(dtype)
    gt = rng.uniform(-1, 18, (2, 32, 64)).astype(dtype)
    return left, right, gt, (gt > 0) & (gt < 16)


def port_step(name, dtype):
    """One training-mode forward and backward of the port at 32x64, batch
    2: ``(outputs, loss, grads, batch_stats)`` in the Flax layout."""
    model, _ = seeded_stereo(name)
    left, right, gt, mask = stereo_batch(dtype)
    model = model.to(torch.float64 if dtype == np.float64 else torch.float32)
    outs = model.train()(torch.from_numpy(left), torch.from_numpy(right))
    assert isinstance(outs, tuple)
    loss = LOSSES[name][0](outs, torch.from_numpy(gt),
                           torch.from_numpy(mask))
    loss.backward()
    stats = {k: v for k, v in flax_arrays_from_state_dict(model).items()
             if k.startswith("['batch_stats']")}
    # Eval mode is untouched: one streaming regression.
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(left), torch.from_numpy(right))
    assert out.shape == (2, 32, 64)
    return ([o.detach().numpy() for o in outs], float(loss.detach()),
            grads_as_flax(model), stats)


def jax_step(name):
    """The same step through the JAX package's ``train=True`` apply with
    ``mutable=["batch_stats"]``, in float64."""
    _, arrays = seeded_stereo(name)
    left, right, gt, mask = stereo_batch(np.float64)
    jmodel = jax_build_stereo_model(name, 16)
    with jax.enable_x64(True):
        variables = nest({k: v.astype(np.float64) for k, v in arrays.items()})

        def loss(params):
            outs, mutated = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                left, right, train=True, mutable=["batch_stats"])
            return (LOSSES[name][1](outs, gt, mask),
                    (outs, mutated["batch_stats"]))

        (j_loss, (j_outs, j_stats)), j_grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(variables["params"])
        return ([np.asarray(o) for o in j_outs], float(j_loss),
                flat({"params": j_grads}), flat({"batch_stats": j_stats}))


@pytest.mark.parametrize("name", ["gwcnet", "msnet2d", "msnet3d"])
def test_stereo_train_step_matches_jax(name):
    """Train-mode outputs (4 for GwcNet, 3 for MSNet), the multi-output
    loss, every gradient and the updated ``batch_stats`` at 32x64,
    disparity 16, batch 2, both packages in float64: outputs within 1e-5
    px (GwcNet's plain volume sums in float32), loss 1e-7 relative, each
    gradient within 1e-5 of its largest entry or 1e-9 of the largest
    gradient (gradients that are 0 exactly, such as a bias that a
    training-mode BatchNorm removes again), statistics 1e-6 relative
    (stored in float32).  In float32 a training-mode BatchNorm over a
    batch of 2 at these sizes normalises by the statistics of as few as
    16 values, which magnifies rounding: there the port's loss is held to
    JAX's float64 loss, within 1e-4 relative."""
    n_out = LOSSES[name][2]
    outs, loss, grads, stats = port_step(name, np.float64)
    j_outs, j_loss, j_grads, j_stats = jax_step(name)
    assert len(outs) == len(j_outs) == n_out
    for got, want in zip(outs, j_outs):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-7)
    top = max(float(np.abs(v).max()) for v in j_grads.values())
    assert_close_rel(grads, j_grads, 1e-5, "grads", floor=1e-9 * top)
    assert_close_rel(stats, j_stats, 1e-6, "batch_stats")
    np.testing.assert_allclose(port_step(name, np.float32)[1], j_loss,
                               rtol=1e-4)


def test_batchnorm_training_matches_flax():
    """Batch statistics with the biased variance, Flax's fast variance
    clipped at 0, and Flax's running update (momentum 0.99)."""
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(3, 5, 4, 7)) * 3 + 2).astype(np.float32)
    scale = rng.uniform(0.5, 2, 5).astype(np.float32)
    bias = rng.normal(size=5).astype(np.float32)
    mean0 = rng.normal(size=5).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 5).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-5, axis=1)
    want, mutated = bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}}, x,
        mutable=["batch_stats"])
    port = BatchNorm(5)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    got = port.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-5)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6)
    # torch's own update would have stored the unbiased variance.
    n = x.size // 5
    unbiased = 0.99 * var0 + 0.01 * x.transpose(1, 0, 2, 3).reshape(5, -1).var(
        axis=1, ddof=1)
    assert np.abs(port.running_var.numpy() - unbiased).max() > 1e-4 / n
    got_eval = port.eval()(torch.from_numpy(x))
    want_eval = fnn.BatchNorm(use_running_average=True, epsilon=1e-5,
                              axis=1).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": stats["mean"], "var": stats["var"]}}, x)
    np.testing.assert_allclose(got_eval.detach().numpy(),
                               np.asarray(want_eval), rtol=0, atol=2e-5)


def test_deep3d_training_loss_and_grads_match_jax():
    """``SyntheticDeep3DTrainer.loss`` with the oracle target and both
    auxiliary terms (weights 0.1 and 0.2), dropout off, at 128x256 on a
    generated batch of 2, against the same loss written with the JAX
    model's unfused ``synthesize_with_probabilities``.  Tolerances: loss
    1e-4 relative, gradients within 2e-3 of each array's largest entry
    (float32; the 65-plane blend and softmax sum in other orders)."""
    trainer = SyntheticDeep3DTrainer(
        height=128, width=256, batch_size=2, seed=7,
        disparity_loss_weight=0.1, ce_loss_weight=0.2,
        photo_target="oracle", device="cpu")
    trainer.dropout = False
    left, down, target, gt_right, gen = trainer.next_batch()
    assert gen is None
    loss = trainer.loss(left, down, target, gt_right, gen)
    loss.backward()

    params = nest(flax_arrays_from_state_dict(trainer.model))["params"]
    jmodel = JaxDeep3D()
    channels = jnp.arange(65, dtype=jnp.float32)
    l, d, t, g = (x.numpy() for x in (left, down, target, gt_right))

    def jax_loss(p):
        pred, prob = jmodel.apply(
            {"params": p}, l, d, train=False,
            method=JaxDeep3D.synthesize_with_probabilities)
        total = jnp.abs(pred - t).mean()
        err = jnp.einsum("ndhw,d->nhw", prob, channels) - g
        huber = jnp.where(jnp.abs(err) <= 1.0, 0.5 * err * err,
                          jnp.abs(err) - 0.5)
        total = total + 0.1 * huber.mean()
        gt_c = jnp.clip(g, 0.0, 64.0)
        lo = jnp.floor(gt_c)
        frac = gt_c - lo
        logp = jnp.log(prob + 1e-9)
        lo_i = lo.astype(jnp.int32)[:, None]
        hi_i = jnp.minimum(lo_i + 1, 64)
        take = jnp.take_along_axis
        ce = -((1.0 - frac) * take(logp, lo_i, axis=1)[:, 0]
               + frac * take(logp, hi_i, axis=1)[:, 0])
        return total + 0.2 * ce.mean()

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-4)
    assert_close_rel(grads_as_flax(trainer.model),
                     flat({"params": want_grads}), 2e-3, "deep3d grads")


def test_deep3d_dropout_follows_the_generator():
    """Training mode drops half the hidden units of the global branch from
    the given generator (same seed, same output; another seed, another),
    and none without one; eval mode runs no dropout."""
    model = Deep3D((32, 64))
    init_deep3d_params(model, 0)
    rng = np.random.default_rng(8)
    full = torch.from_numpy(rng.uniform(0, 1, (1, 3, 128, 256)).astype(
        np.float32))
    down = torch.nn.functional.avg_pool2d(full, 4)
    model.train()
    with torch.no_grad():
        a = model(full, down, torch.Generator().manual_seed(1))
        b = model(full, down, torch.Generator().manual_seed(1))
        c = model(full, down, torch.Generator().manual_seed(2))
        off = model(full, down)
        plain = model.synthesize_with_probabilities(full, down)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(off, plain) and not torch.equal(a, off)


def test_kernel_wrappers_refuse_autograd():
    """A ctypes kernel records no gradient: under grad mode an input that
    requires one is refused, naming the kernel and the way out."""
    x = torch.zeros(2, 3, requires_grad=True)
    for name in ("upsample_blend", "gwc_volume", "matching_core",
                 "sampled_window"):
        with pytest.raises(ValueError, match=f"{name}.*training mode"):
            launch.refuse_autograd(name, torch.zeros(1), x)
    with torch.no_grad():
        launch.refuse_autograd("gwc_volume", x)
    launch.refuse_autograd("gwc_volume", x.detach())
