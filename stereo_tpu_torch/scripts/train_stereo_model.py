"""Train a DNN stereo backend, GwcNet, MSNet2D or MSNet3D (port of
``scripts/train_stereo_model.py``).

    python -m stereo_tpu_torch.scripts.train_stereo_model --model gwcnet \
        --data-dir /data/kitti2015/training
    python -m stereo_tpu_torch.scripts.train_stereo_model --model gwcnet \
        --synthetic --max-disparity 64 --steps 2000 --checkpoint /tmp/g.npz

KITTI 2015 mode reads ``image_2/``, ``image_3/`` and ``disp_occ_0/``
(16-bit disparities) under ``--data-dir``, random-crops to ``--crop``,
checkpoints every epoch (``--checkpoint``, a ``torch.save`` file) and
exports the weights as npz.  ``--synthetic`` trains on generated scenes
and exports to ``--checkpoint`` every ``--export-every`` steps
(``--resume`` starts from the weights there); ``--warmup-steps`` (the
trainer's 100 by default, fixed in the JAX script) must stay under
``--steps``.  The default export is the committed
``data/checkpoints/<model>.npz``: pass a path to keep it.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from stereo_tpu_torch.core.config import TrainerConfig
from stereo_tpu_torch.utils.paths import model_checkpoint_dir


def train_synthetic(args) -> list:
    from stereo_tpu_torch.models import build_stereo_model, load_or_init_params
    from stereo_tpu_torch.train import SyntheticStereoTrainer

    state = None
    if args.resume:
        model = build_stereo_model(args.model, args.max_disparity)
        source = load_or_init_params(model, args.model, tuple(args.crop),
                                     checkpoint_dir=args.checkpoint)
        state = model.state_dict()
        print(f"Resuming {args.model} from {source}.")
    trainer = SyntheticStereoTrainer(
        args.model, max_disparity=args.max_disparity,
        height=args.crop[0], width=args.crop[1],
        batch_size=args.batch_size, learning_rate=args.learning_rate,
        warmup_steps=args.warmup_steps, total_steps=args.steps,
        chunk=args.chunk, state_dict=state, device=args.device)
    out = args.checkpoint or (model_checkpoint_dir(args.model) + ".npz")
    if not out.endswith(".npz"):
        out += ".npz"
    losses = []
    remaining = args.steps
    while remaining > 0:
        seg = min(args.export_every, remaining)
        losses.extend(trainer.train(seg))
        remaining -= seg
        trainer.export(out)
        print(f"checkpointed at step {trainer.step_count} -> {out}",
              flush=True)
    curve_path = os.path.join(os.path.dirname(os.path.abspath(out)),
                              f"{args.model}_synthetic_losses.json")
    with open(curve_path, "w") as f:
        json.dump({"model": args.model, "steps": args.steps,
                   "losses": losses}, f)
    print(f"Exported to {out}; loss curve at {curve_path}")
    return losses


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True,
                        choices=["gwcnet", "msnet2d", "msnet3d"])
    parser.add_argument("--synthetic", action="store_true",
                        help="train on generated scenes (no dataset needed)")
    parser.add_argument("--steps", type=int, default=2000,
                        help="synthetic mode: number of train steps")
    parser.add_argument("--chunk", type=int, default=20,
                        help="synthetic mode: steps between loss readbacks")
    parser.add_argument("--warmup-steps", type=int, default=100,
                        help="synthetic mode: linear warmup before the "
                             "cosine decay; must be under --steps")
    parser.add_argument("--data-dir", default=None,
                        help="KITTI 2015 training root (image_2/ image_3/ "
                             "disp_occ_0/)")
    parser.add_argument("--max-disparity", type=int, default=192)
    parser.add_argument("--n-epochs", type=int, default=300)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--learning-rate", type=float, default=1e-3)
    parser.add_argument("--crop", nargs=2, type=int, default=[256, 512])
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--export-every", type=int, default=5000,
                        help="synthetic mode: export every N steps")
    parser.add_argument("--export-dir", default=None,
                        help="KITTI mode: where the weights are exported "
                             "(default data/checkpoints/<model>.npz)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.steps <= 0:
        parser.error("--steps must be >= 1")
    if args.export_every <= 0:
        parser.error("--export-every must be >= 1 (it is the segment size "
                     "of the segmented-export loop)")
    if not args.synthetic and not args.data_dir:
        parser.error("--data-dir is required without --synthetic")
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.synthetic:
        return train_synthetic(args)
    from stereo_tpu_torch.train import Kitti2015StereoDataset, StereoTrainer

    def files(sub):
        return sorted(glob.glob(os.path.join(args.data_dir, sub, "*_10.png")))

    dataset = Kitti2015StereoDataset(files("image_2"), files("image_3"),
                                     files("disp_occ_0"),
                                     crop=tuple(args.crop))
    print(f"Training {args.model} on {len(dataset)} pairs.")
    checkpoint = args.checkpoint or f"data/checkpoints/{args.model}_train"
    config = TrainerConfig(n_epochs=args.n_epochs, batch_size=args.batch_size,
                           learning_rate=args.learning_rate,
                           save_path=checkpoint)
    trainer = StereoTrainer(args.model, args.max_disparity, config,
                            image_shape=tuple(args.crop), device=args.device)
    if args.resume and os.path.isfile(checkpoint):
        trainer.load_checkpoint(checkpoint)
        print(f"Resumed from epoch {trainer.epoch}.")
    losses = trainer.train(dataset)
    out = args.export_dir or (model_checkpoint_dir(args.model) + ".npz")
    trainer.export_inference_variables(out)
    print(f"Exported to {out}")
    return losses


if __name__ == "__main__":
    main()
