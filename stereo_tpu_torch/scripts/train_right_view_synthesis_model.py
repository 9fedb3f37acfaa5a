"""Train the Deep3D right-view-synthesis model (port of
``scripts/train_right_view_synthesis_model.py``).

    python -m stereo_tpu_torch.scripts.train_right_view_synthesis_model \
        --drive-dirs /data/kitti/2011_09_26/2011_09_26_drive_0001_sync
    python -m stereo_tpu_torch.scripts.train_right_view_synthesis_model \
        --synthetic --steps 2000 --export-dir /tmp/deep3d.npz

KITTI mode trains at the native 384x1280 / 96x320 for ``--n-epochs`` with
a checkpoint per epoch (``--checkpoint``: a ``torch.save`` file, or an
Orbax directory as the JAX script writes it, which then stays one;
``--resume`` continues from either) and exports the weights as npz to
``--export-dir``.
``--synthetic`` trains on generated depth-prior scenes at ``--crop`` and
exports every ``--export-every`` steps (``--warm-start`` adopts a
checkpoint's matching-shape weights).  The defaults write to the committed
``data/checkpoints/deep3d.npz``: pass ``--export-dir`` to keep it.
"""

from __future__ import annotations

import argparse
import json
import os

from stereo_tpu_torch.core.config import TrainerConfig
from stereo_tpu_torch.utils.paths import DEEP3D_CHECKPOINT_DIR


def npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def train_synthetic(args) -> list:
    """Deep3D on generated scenes, exported in segments of
    ``--export-every`` steps; returns the per-step losses."""
    from stereo_tpu_torch.models import load_deep3d_npz
    from stereo_tpu_torch.train import SyntheticDeep3DTrainer

    init_state = None
    if args.warm_start:
        init_state, _ = load_deep3d_npz(args.warm_start)
        print(f"Warm-starting from {args.warm_start}")
    trainer = SyntheticDeep3DTrainer(
        height=args.crop[0], width=args.crop[1],
        batch_size=args.batch_size, learning_rate=args.learning_rate,
        chunk=args.chunk, disparity_loss_weight=args.disparity_loss_weight,
        ce_loss_weight=args.ce_loss_weight,
        min_scene_disparity=args.min_scene_disparity,
        schedule_steps=(args.steps if args.cosine_schedule else 0),
        init_state=init_state, prob_volume_scale=args.prob_volume_scale,
        photo_target=args.photo_target, device=args.device)
    out = npz_path(args.export_dir)
    losses = []
    remaining = args.steps
    while remaining > 0:
        seg = min(args.export_every, remaining)
        losses.extend(trainer.train(seg))
        remaining -= seg
        trainer.export(out)
        print(f"checkpointed at step {trainer.step_count} -> {out}",
              flush=True)
    curve = os.path.join(os.path.dirname(os.path.abspath(out)),
                         "deep3d_synthetic_losses.json")
    with open(curve, "w") as f:
        json.dump({"steps": args.steps, "crop": args.crop,
                   "disparity_loss_weight": args.disparity_loss_weight,
                   "ce_loss_weight": args.ce_loss_weight,
                   "photo_target": args.photo_target,
                   "min_scene_disparity": args.min_scene_disparity,
                   "cosine_schedule": args.cosine_schedule,
                   "batch_size": args.batch_size,
                   "prob_volume_scale": args.prob_volume_scale,
                   "warm_start": args.warm_start, "losses": losses}, f)
    print(f"Exported to {out}; loss curve at {curve}")
    return losses


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--drive-dirs", nargs="+", default=None)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--chunk", type=int, default=10,
                        help="synthetic mode: steps between loss readbacks")
    parser.add_argument("--crop", nargs=2, type=int, default=[256, 512])
    parser.add_argument("--n-epochs", type=int, default=130)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--learning-rate", type=float, default=2e-4)
    parser.add_argument("--disparity-loss-weight", type=float, default=0.0,
                        help="synthetic mode: weight of the Huber loss "
                             "between the volume's soft-argmax and the "
                             "exact right-frame disparity (0 = photometric "
                             "only)")
    parser.add_argument("--ce-loss-weight", type=float, default=0.0,
                        help="synthetic mode: weight of the cross-entropy "
                             "to the two channels around the true "
                             "disparity")
    parser.add_argument("--min-scene-disparity", type=float, default=6.0,
                        help="synthetic mode: the scene family's minimum "
                             "disparity; must match the evaluation's (6.0)")
    parser.add_argument("--photo-target", default="right",
                        choices=["right", "oracle"],
                        help="synthetic mode: photometric target, the true "
                             "right view or the left warped by the exact "
                             "disparity")
    parser.add_argument("--cosine-schedule", action="store_true",
                        help="synthetic mode: warmup-cosine decay over "
                             "--steps instead of a constant rate")
    parser.add_argument("--export-every", type=int, default=5000,
                        help="synthetic mode: export every N steps")
    parser.add_argument("--prob-volume-scale", type=int, default=4,
                        choices=[2, 4])
    parser.add_argument("--warm-start", default=None,
                        help="synthetic mode: .npz whose matching-shape "
                             "weights seed the model")
    parser.add_argument("--checkpoint", default="data/checkpoints/deep3d_train",
                        help="KITTI mode: the per-epoch training state "
                             "(a torch.save file, or an Orbax directory)")
    parser.add_argument("--export-dir", default=DEEP3D_CHECKPOINT_DIR)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.steps <= 0:
        parser.error("--steps must be >= 1")
    if args.export_every <= 0:
        parser.error("--export-every must be >= 1 (it is the segment size "
                     "of the segmented-export loop)")
    if not args.synthetic and not args.drive_dirs:
        parser.error("--drive-dirs is required without --synthetic")
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.synthetic:
        return train_synthetic(args)
    from stereo_tpu_torch.train import KittiStereoDataset, Trainer

    config = TrainerConfig(n_epochs=args.n_epochs, batch_size=args.batch_size,
                           learning_rate=args.learning_rate,
                           save_path=args.checkpoint)
    trainer = Trainer(config=config, device=args.device)
    if args.resume and os.path.exists(args.checkpoint):
        trainer.load_checkpoint(args.checkpoint)
        print(f"Resumed from epoch {trainer.epoch}.")
    dataset = KittiStereoDataset(args.drive_dirs)
    print(f"Training on {len(dataset)} stereo pairs.")
    losses = trainer.train(dataset)
    out = npz_path(args.export_dir)
    trainer.export_inference_variables(out)
    print(f"Exported inference parameters to {out}")
    return losses


if __name__ == "__main__":
    main()
