"""Deep3D right-view-synthesis trainer on KITTI drives (port of
``stereo_tpu/train/trainer.py``).

L1 reconstruction loss against the real right view; Adam with coupled L2
weight decay (``torch.optim.Adam(weight_decay=...)`` adds ``wd * param``
to the gradient before the moments: the JAX package's
``add_decayed_weights`` ahead of ``scale_by_adam``); the StepLR learning
rate per epoch; per-epoch mean losses; a checkpoint per epoch for resume
(``torch.save`` of model, optimizer and epoch: the port's counterpart of
the JAX package's Orbax save, which it cannot write) and an npz export in
the committed format.  The model trains in its training mode: the
differentiable blend and the global branch's dropout, drawn from the
trainer's own ``torch.Generator``.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from ..core.config import TrainerConfig
from ..core.device import resolve_device, set_float32_precision
from ..models import Deep3D, init_deep3d_params, save_params_npz
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

    def save_checkpoint(self, path: str) -> None:
        """Model, optimizer state and epoch, for ``load_checkpoint``."""
        save_training_state(path, self.model, self.optimizer, self.epoch)

    def load_checkpoint(self, path: str) -> None:
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
    """Restore ``save_training_state``'s file into ``model`` and
    ``optimizer``; returns the epoch."""
    state = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["epoch"])
