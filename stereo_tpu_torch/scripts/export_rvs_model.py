"""Export trained Deep3D parameters for inference (port of
``scripts/export_rvs_model.py``).

    python -m stereo_tpu_torch.scripts.export_rvs_model \
        --checkpoint CHECKPOINT --export-dir /tmp/deep3d

``--checkpoint`` is a training checkpoint of the Deep3D trainer: the port's
``torch.save`` file or an Orbax training directory (JAX's
``Trainer.save_checkpoint``, or the port's with ``format="orbax"``).  The
parameters go to ``--export-dir`` in what ``RightViewSynthesis`` loads: an
Orbax directory, as the JAX package's script writes, or an npz file when
the path ends in ``.npz``.  The default is the committed
``data/checkpoints/deep3d``, which its ``deep3d.npz`` shadows in both
packages' lookup order: pass ``--export-dir``.
"""

from __future__ import annotations

import argparse

from stereo_tpu_torch.utils.paths import DEEP3D_CHECKPOINT_DIR


def main(argv=None) -> None:
    from stereo_tpu_torch.models import save_params
    from stereo_tpu_torch.train import Trainer

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkpoint", required=True,
                        help="training checkpoint (torch.save file or "
                             "Orbax directory)")
    parser.add_argument("--export-dir", default=DEEP3D_CHECKPOINT_DIR)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    trainer = Trainer(device=args.device)
    trainer.load_checkpoint(args.checkpoint)
    if args.export_dir.endswith(".npz"):
        trainer.export_inference_variables(args.export_dir)
    else:
        save_params(trainer.model, args.export_dir)
    print(f"Exported epoch-{trainer.epoch} parameters to {args.export_dir}")


if __name__ == "__main__":
    main()
