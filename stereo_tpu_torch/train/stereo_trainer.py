"""Supervised trainer of the DNN stereo backends, GwcNet and MSNet2D/3D
(port of ``stereo_tpu/train/stereo_trainer.py``).

The multi-output smooth-L1 losses (``gwcnet_loss``, ``msnet_loss``) over
ground truth masked to ``0 < gt < max_disparity``, AdamW (decoupled weight
decay, ``optax.adamw``'s rule), random-crop batches of KITTI 2015 style
triplets, and BatchNorm statistics updated by the networks' training mode
(Flax's rule).  Checkpoints are ``torch.save`` files for resume (or Orbax
trees as JAX's trainer writes them), exports npz files both packages
load.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import TrainerConfig
from ..core.device import resolve_device, set_float32_precision
from ..models import (build_stereo_model, gwcnet_loss, init_params,
                      msnet_loss, save_params_npz)
from ..pipeline.backends import normalize_imagenet
from ..utils.image_io import decode_image, disparity_of, read_image_chw
from .trainer import (checkpoint_format, load_training_state, optax_adam_state,
                      save_orbax_training_state, save_training_state,
                      to_device)

LOSSES = {"gwcnet": gwcnet_loss, "msnet2d": msnet_loss, "msnet3d": msnet_loss}


def read_disparity(path: str) -> np.ndarray:
    """A ground-truth disparity file -> (H, W) float32, as the JAX trainer
    reads it (``np.asarray`` of PIL's image, its first channel): 16-bit grey
    (KITTI's PNG, a 16-bit TIFF, a PGM at a maxval over 255) holds
    ``disparity * 256`` and is divided by 256 (by the file's mode, never by
    its values); float files (``Pf`` PFM, float TIFF) and 8-bit grey give
    the disparity itself; a palette (PNG, BMP, GIF, TIFF) its index; a
    bitmap 0 or 1; colour its red channel (16-bit colour its high byte),
    CMYK its cyan.  The format is told by the signature
    (``utils.image_io.decode_image``, ``disparity_of``)."""
    with open(path, "rb") as f:
        return disparity_of(decode_image(f.read()))


def read_disparity_png(path: str) -> np.ndarray:
    """A KITTI ground-truth PNG -> (H, W) float32 disparities
    (``read_disparity``, which reads the other formats too)."""
    return read_disparity(path)


class Kitti2015StereoDataset:
    """KITTI-2015-style training triplets: left/right images and ground-truth
    disparity files (16-bit PNGs, or any format ``read_disparity`` takes),
    random-cropped to ``crop`` (H, W)."""

    def __init__(self, left_paths: Sequence[str], right_paths: Sequence[str],
                 disparity_paths: Sequence[str],
                 crop: Tuple[int, int] = (256, 512)):
        if not (len(left_paths) == len(right_paths) == len(disparity_paths)):
            raise RuntimeError("Mismatched dataset file lists.")
        self.lefts = list(left_paths)
        self.rights = list(right_paths)
        self.disps = list(disparity_paths)
        self.crop = crop

    def __len__(self) -> int:
        return len(self.lefts)

    def load(self, idx: int, rng: np.random.Generator):
        """One triplet cropped at a corner drawn from ``rng`` (row, then
        column, as the JAX package draws them)."""
        left = read_image_chw(self.lefts[idx])
        right = read_image_chw(self.rights[idx])
        disp = read_disparity(self.disps[idx])
        ch, cw = self.crop
        h, w = left.shape[-2:]
        y = int(rng.integers(0, max(1, h - ch + 1)))
        x = int(rng.integers(0, max(1, w - cw + 1)))
        return (left[:, y:y + ch, x:x + cw], right[:, y:y + ch, x:x + cw],
                disp[y:y + ch, x:x + cw])

    def batches(self, batch_size: int, seed: int = 0):
        """Shuffled full batches: ``(left, right, gt)`` numpy arrays."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self))
        for b in range(len(order) // batch_size):
            idxs = order[b * batch_size:(b + 1) * batch_size]
            items = [self.load(int(i), rng) for i in idxs]
            yield tuple(np.stack(parts) for parts in zip(*items))


def stereo_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                loss_fn, max_disparity: int, left: torch.Tensor,
                right: torch.Tensor, gt: torch.Tensor,
                clip_norm: Optional[float] = None) -> torch.Tensor:
    """One step of a stereo network in training mode on 0..255 views:
    ImageNet normalisation, the masked loss over ``0 < gt < max_disparity``,
    backward, an optional global-norm clip, the optimizer's update.
    Returns the loss (on the device, not synchronised)."""
    mask = (gt > 0) & (gt < max_disparity)
    outputs = model(normalize_imagenet(left), normalize_imagenet(right))
    loss = loss_fn(outputs, gt, mask)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if clip_norm is not None:
        clip_global_norm(model.parameters(), clip_norm)
    optimizer.step()
    return loss.detach()


def clip_global_norm(params, max_norm: float) -> None:
    """``optax.clip_by_global_norm``: scale every gradient by
    ``max_norm / norm`` when the global norm exceeds ``max_norm``."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


class StereoTrainer:
    """Training loop for one stereo network on ``device`` (default
    ``"cuda"``).  ``state_dict`` starts from given weights, else a seeded
    init (``models.init_params``)."""

    def __init__(self, model_name: str, max_disparity: int = 192,
                 config: TrainerConfig = TrainerConfig(),
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 image_shape: Tuple[int, int] = (256, 512), seed: int = 0,
                 device="cuda"):
        del image_shape     # the networks are fully convolutional
        self.device = resolve_device(device)
        set_float32_precision("float32")
        self.model_name = model_name
        self.max_disparity = max_disparity
        self.config = config
        self.loss_fn = LOSSES[model_name]
        model = build_stereo_model(model_name, max_disparity)
        if state_dict is None:
            init_params(model, seed)
        else:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).train()
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=config.learning_rate,
            betas=(config.momentum, 0.999), eps=1e-8,
            weight_decay=config.weight_decay)
        self.epoch = 0

    def train_step(self, left, right, gt) -> torch.Tensor:
        return stereo_step(self.model, self.optimizer, self.loss_fn,
                           self.max_disparity, left, right, gt)

    def train(self, dataset: Kitti2015StereoDataset,
              n_epochs: Optional[int] = None) -> List[float]:
        cfg = self.config
        n_epochs = n_epochs if n_epochs is not None else cfg.n_epochs
        epoch_losses = []
        for epoch in range(self.epoch, n_epochs):
            start = time.time()
            losses = [self.train_step(*to_device(batch, self.device))
                      for batch in dataset.batches(cfg.batch_size,
                                                   seed=epoch)]
            mean_loss = (float(torch.stack(losses).mean()) if losses
                         else float("nan"))
            print(f"[{self.model_name}] epoch {epoch}: loss {mean_loss:.4f} "
                  f"({time.time() - start:.1f}s)")
            epoch_losses.append(mean_loss)
            self.epoch = epoch + 1
            if cfg.save_path:
                self.save_checkpoint(cfg.save_path)
        return epoch_losses

    def save_checkpoint(self, path: str, format: Optional[str] = None) -> None:
        """Model (BatchNorm statistics included), optimizer and epoch: a
        ``torch.save`` file, or with ``format="orbax"`` the tree JAX's
        ``StereoTrainer.save_checkpoint`` writes ({params, batch_stats,
        opt_state, epoch}, the optax state of ``adamw``).  The default
        format is ``checkpoint_format``'s."""
        if checkpoint_format(path, format) == "orbax":
            save_orbax_training_state(
                path, self.model,
                [optax_adam_state(self.model, self.optimizer), None, None],
                self.epoch)
        else:
            save_training_state(path, self.model, self.optimizer, self.epoch)

    def load_checkpoint(self, path: str) -> None:
        """Resume from ``save_checkpoint``'s file or from an Orbax training
        checkpoint (a directory) of either package."""
        self.epoch = load_training_state(path, self.model, self.optimizer,
                                         self.device)

    def export_inference_variables(self, npz_path: str) -> None:
        """Parameters and ``batch_stats`` as a committed-format npz."""
        save_params_npz(self.model, npz_path)
