"""Deep3D right-view-synthesis trainer on KITTI drives (port of
``stereo_tpu/train/trainer.py``).

L1 reconstruction loss against the real right view; Adam with coupled L2
weight decay (``torch.optim.Adam(weight_decay=...)`` adds ``wd * param``
to the gradient before the moments: the JAX package's
``add_decayed_weights`` ahead of ``scale_by_adam``); the StepLR learning
rate per epoch; per-epoch mean losses; a checkpoint per epoch for resume
(``torch.save`` of model, optimizer and epoch, or, with
``format="orbax"``, the JAX trainer's Orbax tree of params, optax state and
epoch, which ``load_checkpoint`` also reads) and an npz export in the
committed format.  The model trains in its training mode: the
differentiable blend and the global branch's dropout, drawn from the
trainer's own ``torch.Generator``.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..core.config import TrainerConfig
from ..core.device import resolve_device, set_float32_precision
from ..models import (Deep3D, flax_arrays_from_state_dict, float_variables,
                      init_deep3d_params, load_params, nest_variables,
                      save_params_npz, state_dict_from_flax)
from ..utils.orbax import write_tree
from .kitti_dataset import (RVS_DOWNSCALED_SHAPE, RVS_FULL_SHAPE,
                            KittiStereoDataset, batch_iterator)


def make_optimizer(params, config: TrainerConfig) -> torch.optim.Adam:
    """Adam (beta1 ``config.momentum``, beta2 0.999, eps 1e-8) with coupled
    L2 weight decay, at ``config.learning_rate``."""
    return torch.optim.Adam(params, lr=config.learning_rate,
                            betas=(config.momentum, 0.999), eps=1e-8,
                            weight_decay=config.weight_decay)


def step_lr_for_epoch(config: TrainerConfig, epoch: int) -> float:
    """torch ``StepLR`` semantics: lr * gamma^(epoch // step_size)."""
    return config.learning_rate * (config.gamma ** (epoch // config.step_size))


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def to_device(arrays, device) -> List[torch.Tensor]:
    return [torch.as_tensor(a).to(device, non_blocking=True) for a in arrays]


class Trainer:
    """Owns a Deep3D model in training mode, its optimizer and the epoch
    loop.  ``state_dict`` starts from given weights (else the JAX
    initializers, seeded); ``dropout=False`` turns the global branch's
    dropout off (a step is then deterministic)."""

    def __init__(self, model: Optional[Deep3D] = None,
                 config: TrainerConfig = TrainerConfig(),
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, device="cuda", dropout: bool = True):
        self.device = resolve_device(device)
        set_float32_precision("float32")
        model = model or Deep3D(RVS_DOWNSCALED_SHAPE)
        if state_dict is None:
            init_deep3d_params(model, seed)
        else:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).train()
        self.config = config
        self.optimizer = make_optimizer(self.model.parameters(), config)
        self.generator = torch.Generator(device=self.device)
        self.dropout = dropout
        self.epoch = 0

    def train_step(self, left_full: torch.Tensor, left_down: torch.Tensor,
                   right_full: torch.Tensor) -> torch.Tensor:
        """One step on device tensors in 0..1; returns the loss (on the
        device, not synchronised)."""
        pred = self.model(left_full, left_down,
                          self.generator if self.dropout else None)
        loss = (pred - right_full).abs().mean()
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train(self, dataset: KittiStereoDataset,
              n_epochs: Optional[int] = None) -> Sequence[float]:
        """Run the epoch loop; returns per-epoch mean losses."""
        cfg = self.config
        n_epochs = n_epochs if n_epochs is not None else cfg.n_epochs
        # The JAX trainer keys its dropout with PRNGKey(epoch) on entry.
        self.generator.manual_seed(self.epoch)
        epoch_losses = []
        for epoch in range(self.epoch, n_epochs):
            start = time.time()
            losses = []
            set_learning_rate(self.optimizer, step_lr_for_epoch(cfg, epoch))
            it = batch_iterator(dataset, cfg.batch_size, shuffle=True,
                                seed=epoch)
            for step, batch in enumerate(it):
                loss = self.train_step(*to_device(batch, self.device))
                losses.append(loss)
                if cfg.log_every and (step + 1) % cfg.log_every == 0:
                    print(f"epoch {epoch} step {step + 1}: "
                          f"loss {float(loss):.5f}")
            mean_loss = (float(torch.stack(losses).mean()) if losses
                         else float("nan"))
            print(f"Epoch {epoch}: mean loss {mean_loss:.5f} "
                  f"({time.time() - start:.1f}s)")
            epoch_losses.append(mean_loss)
            self.epoch = epoch + 1
            if cfg.save_path:
                self.save_checkpoint(cfg.save_path)
        return epoch_losses

    def save_checkpoint(self, path: str, format: Optional[str] = None) -> None:
        """Model, optimizer state and epoch, for ``load_checkpoint``: a
        ``torch.save`` file, or with ``format="orbax"`` the tree JAX's
        ``Trainer.save_checkpoint`` writes ({params, opt_state, epoch},
        the optax state of ``inject_hyperparams`` over coupled Adam), which
        its ``load_checkpoint`` resumes.  The default format is
        :func:`checkpoint_format`'s."""
        if checkpoint_format(path, format) == "orbax":
            cfg = self.config
            opt_state = {
                "count": np.asarray(adam_count(self.optimizer), np.int32),
                "hyperparams": {k: np.asarray(v, np.float32) for k, v in (
                    ("b1", cfg.momentum), ("b2", 0.999),
                    ("learning_rate",
                     self.optimizer.param_groups[0]["lr"]),
                    ("weight_decay", cfg.weight_decay))},
                "hyperparams_states": {},
                "inner_state": [None, optax_adam_state(self.model,
                                                       self.optimizer), None]}
            save_orbax_training_state(path, self.model, opt_state,
                                      self.epoch)
        else:
            save_training_state(path, self.model, self.optimizer, self.epoch)

    def load_checkpoint(self, path: str) -> None:
        """Resume from ``save_checkpoint``'s file or from an Orbax training
        checkpoint (a directory) of either package."""
        self.epoch = load_training_state(path, self.model, self.optimizer,
                                         self.device)

    def export_inference_variables(self, npz_path: str) -> None:
        """The weights as a committed-format npz for ``RightViewSynthesis``
        (and the JAX package), with the resolution they were trained at."""
        export_deep3d(self.model, npz_path, RVS_FULL_SHAPE)


def export_deep3d(model: Deep3D, npz_path: str, full_shape) -> None:
    """Deep3D's weights -> npz with the ``meta`` the synthesis wrapper
    adopts: its global branch ties the weights to the training size."""
    h, w = (int(v) for v in full_shape)
    save_params_npz(model, npz_path, meta={
        "full_shape": [h, w], "down_shape": [h // 4, w // 4],
        "prob_volume_scale": model.prob_volume_scale})


def checkpoint_format(path: str, format: Optional[str] = None) -> str:
    """The format of a trainer's checkpoint at ``path``: ``format`` when
    given, else ``"orbax"`` where ``path`` is a directory (the JAX
    trainers' checkpoint, which ``torch.save`` cannot overwrite; a resumed
    directory is saved back in place), else ``"torch"``."""
    return format or ("orbax" if os.path.isdir(path) else "torch")


def save_training_state(path: str, model: nn.Module,
                        optimizer: torch.optim.Optimizer, epoch: int,
                        **extra) -> None:
    """``torch.save`` of model, optimizer and epoch (and ``extra``), to a
    temporary name and then renamed, so a crash never leaves half a
    checkpoint."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(), "epoch": epoch,
                **extra}, tmp)
    os.replace(tmp, path)


def load_training_state(path: str, model: nn.Module,
                        optimizer: torch.optim.Optimizer, device) -> int:
    """Restore ``save_training_state``'s file, or an Orbax training
    checkpoint directory (JAX's trainers' or ``save_orbax_training_state``'s),
    into ``model`` and ``optimizer``; returns the epoch."""
    if os.path.isdir(path):
        tree = load_params(path)
        model.load_state_dict(state_dict_from_flax(model,
                                                   float_variables(tree)))
        load_optax_state(model, optimizer, tree["opt_state"])
        return int(tree["epoch"])
    state = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["epoch"])


def save_orbax_training_state(path: str, model: nn.Module, opt_state,
                              epoch: int) -> None:
    """An Orbax training checkpoint as the JAX trainers write it: the
    model's Flax variables (``params``, and ``batch_stats`` where it has
    BatchNorm), ``opt_state`` (an optax state tree) and ``epoch``."""
    tree = nest_variables(flax_arrays_from_state_dict(model))
    tree.update(opt_state=opt_state, epoch=int(epoch))
    write_tree(path, tree)


def adam_count(optimizer: torch.optim.Optimizer) -> int:
    """The optimizer's step count (optax's ``count``): 0 before the first
    step."""
    for state in optimizer.state.values():
        if "step" in state:
            return int(state["step"])
    return 0


def optax_adam_state(model: nn.Module,
                     optimizer: torch.optim.Optimizer) -> dict:
    """torch Adam's or AdamW's moments as optax's ``ScaleByAdamState``
    fields: ``count`` and the Flax-layout trees ``mu`` and ``nu`` of
    ``exp_avg`` and ``exp_avg_sq`` (zeros before the first step)."""
    moments = {"mu": {}, "nu": {}}
    for name, p in model.named_parameters():
        state = optimizer.state.get(p, {})
        for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            moments[field][name] = state.get(key, torch.zeros_like(p))
    return {"count": np.asarray(adam_count(optimizer), np.int32),
            **{field: nest_variables(flax_arrays_from_state_dict(
                model, named))["params"]
               for field, named in moments.items()}}


def _find_adam_state(tree):
    """The ``ScaleByAdamState`` (a dict with ``count``, ``mu`` and ``nu``)
    inside an optax state tree read from Orbax, or None."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        nodes = list(tree.values())
    elif isinstance(tree, list):
        nodes = tree
    else:
        return None
    for node in nodes:
        found = _find_adam_state(node)
        if found is not None:
            return found
    return None


def load_optax_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                     opt_state) -> None:
    """Map an optax Adam or AdamW state onto ``optimizer``: ``mu`` and
    ``nu`` become each parameter's ``exp_avg`` and ``exp_avg_sq`` through
    the Flax -> torch key map, ``count`` its ``step``; the learning rate of
    ``inject_hyperparams`` (JAX's Deep3D trainer) becomes every group's."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no optax Adam state (count, mu, nu) in the "
                         "checkpoint's opt_state")
    count = int(np.asarray(adam["count"]))
    optimizer.state.clear()
    if count:
        mu, nu = (state_dict_from_flax(model, float_variables(
            {"params": adam[field]}, ("params",))) for field in ("mu", "nu"))
        for name, p in model.named_parameters():
            optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu[name].to(p.device, p.dtype),
                "exp_avg_sq": nu[name].to(p.device, p.dtype)}
    hyper = opt_state.get("hyperparams") if isinstance(opt_state, dict) \
        else None
    if hyper and "learning_rate" in hyper:
        set_learning_rate(optimizer, float(np.asarray(hyper["learning_rate"])))
