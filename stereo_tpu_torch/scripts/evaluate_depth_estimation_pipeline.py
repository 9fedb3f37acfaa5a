"""Evaluate every backend x right-view-synthesis combination over KITTI
drives (port of ``scripts/evaluate_depth_estimation_pipeline.py``).

    python -m stereo_tpu_torch.scripts.evaluate_depth_estimation_pipeline \
        --drive-dirs /data/kitti/2011_09_26/2011_09_26_drive_0001_sync

Grid over drives x {rvs off, rvs on} x backends; the six metrics (D1,
Threshold_1/2/3/5, MAE) against Velodyne ground truth, dumped as JSON to a
timestamped file in ``--output-dir``.  ``--synthetic`` evaluates on
held-out generated scenes with exact ground truth instead
(``SyntheticStereoCamera``; the defaults are the JAX package's accuracy
record's protocol: seed 20260817, 8 frames at 384x1280).
"""

from __future__ import annotations

import argparse
import json
import os

from stereo_tpu_torch.pipeline import (DepthEstimationPipeline,
                                       extract_config_from_camera,
                                       run_depth_estimation_pipeline_evaluation)
from stereo_tpu_torch.pipeline.camera import (KittiSingleViewCamera,
                                              SyntheticStereoCamera)
from stereo_tpu_torch.pipeline.metrics import default_metrics
from stereo_tpu_torch.utils.paths import timestamp_folder_name


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--drive-dirs", nargs="+", default=None)
    parser.add_argument("--synthetic", action="store_true",
                        help="evaluate on held-out generated scenes with "
                             "exact GT (no KITTI data needed)")
    parser.add_argument("--n-frames", type=int, default=8,
                        help="synthetic mode: frames per evaluation")
    parser.add_argument("--image-shape", nargs=2, type=int,
                        default=[384, 1280], help="synthetic mode: (H, W)")
    parser.add_argument("--seed", type=int, default=20260817,
                        help="synthetic mode: held-out scene seed")
    parser.add_argument("--backends", nargs="+",
                        default=["classical", "gwcnet", "msnet3d"])
    parser.add_argument("--rvs", nargs="+", default=["off", "on"],
                        choices=["off", "on"],
                        help="evaluate with the real right view (off) and/or "
                             "the synthesized one (on)")
    parser.add_argument("--rvs-checkpoint", default=None,
                        help="Deep3D .npz for the rvs_on arms (default: the "
                             "committed weights)")
    parser.add_argument("--compute-dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="precision of the neural paths (DNN backends + "
                             "right-view synthesis)")
    parser.add_argument("--output-dir", default="results/evaluation")
    parser.add_argument("--only-one", action="store_true",
                        help="one frame per drive (smoke run)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if not args.synthetic and not args.drive_dirs:
        parser.error("--drive-dirs is required without --synthetic")
    return args


def make_camera(args, drive, rvs):
    if args.synthetic:
        # The rvs-on arms run on depth-prior scenes (appearance predicts
        # depth, as on KITTI); random-disparity scenes cannot be solved
        # from one view.
        return SyntheticStereoCamera(
            n_frames=(1 if args.only_one else args.n_frames),
            height=args.image_shape[0], width=args.image_shape[1],
            return_right_view=(rvs == "off"), seed=args.seed,
            depth_prior=(rvs == "on"), device=args.device)
    return KittiSingleViewCamera(drive, return_right_view=(rvs == "off"),
                                 only_one=args.only_one)


def main(argv=None) -> dict:
    args = parse_args(argv)
    results = {}
    shared_synthesis = None     # one Deep3D for the whole rvs_on grid
    drives = ["synthetic"] if args.synthetic else args.drive_dirs
    for drive in drives:
        drive_key = os.path.basename(os.path.normpath(drive))
        for rvs in args.rvs:
            for backend in args.backends:
                camera = make_camera(args, drive, rvs)
                config = extract_config_from_camera(camera).update(
                    stereo_matching_backend=backend,
                    rvs_checkpoint=args.rvs_checkpoint,
                    compute_dtype=args.compute_dtype)
                if rvs == "on" and shared_synthesis is None:
                    from stereo_tpu_torch.synthesis import RightViewSynthesis

                    shared_synthesis = RightViewSynthesis(
                        output_shape=camera.get_image_shape(),
                        compute_dtype=config.compute_dtype,
                        checkpoint_dir=args.rvs_checkpoint,
                        device=args.device)
                pipeline = DepthEstimationPipeline(
                    config,
                    synthesis=(shared_synthesis if rvs == "on" else None),
                    device=args.device)
                key = f"{drive_key}/rvs_{rvs}/{backend}"
                print(f"=== {key}")
                results[key] = run_depth_estimation_pipeline_evaluation(
                    camera, pipeline, default_metrics())
                print(json.dumps(results[key], indent=2))

    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir,
                            f"evaluation_{timestamp_folder_name()}.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"Wrote {out_path}")
    return results


if __name__ == "__main__":
    main()
