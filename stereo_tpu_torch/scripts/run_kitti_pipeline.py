"""Run the depth-estimation pipeline over a KITTI drive with each backend
(port of ``scripts/run_kitti_pipeline.py``).

    python -m stereo_tpu_torch.scripts.run_kitti_pipeline \
        --drive-dir /data/kitti/2011_09_26/2011_09_26_drive_0001_sync

Streams the drive through each selected backend with a completion logger,
a context-frame saver and a context video (``<backend>.mp4``, MPEG-4 Part 2
as the JAX package writes it) under ``--save-dir/<backend>/``.
"""

from __future__ import annotations

import argparse
import os

from stereo_tpu_torch.pipeline import (DepthEstimationPipeline,
                                       extract_config_from_camera,
                                       run_depth_estimation_pipeline,
                                       run_depth_estimation_pipeline_batched)
from stereo_tpu_torch.pipeline.camera import KittiSingleViewCamera
from stereo_tpu_torch.pipeline.hooks import (ContextFrameSaver,
                                             ContextVideoSaver,
                                             DisparityMapCompletionLogger)

# The video's frame rate per backend, as in the JAX package's script.
BACKEND_VIDEO_FPS = {"classical": 30, "gwcnet": 6, "msnet3d": 4, "msnet2d": 6}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--drive-dir", required=True,
                        help="KITTI raw drive directory (contains image_02/)")
    parser.add_argument("--save-dir", default="results/kitti")
    parser.add_argument("--backends", nargs="+",
                        default=["classical", "gwcnet", "msnet3d"])
    parser.add_argument("--use-right-view", action="store_true",
                        help="feed the real right view instead of RVS")
    parser.add_argument("--batch-size", type=int, default=0,
                        help="run frames through process_batch in batches "
                             "of this size")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    for backend in args.backends:
        camera = KittiSingleViewCamera(args.drive_dir,
                                       return_right_view=args.use_right_view)
        config = extract_config_from_camera(camera).update(
            stereo_matching_backend=backend)
        pipeline = DepthEstimationPipeline(config, device=args.device)
        hooks = [
            DisparityMapCompletionLogger(),
            ContextFrameSaver(os.path.join(args.save_dir, backend)),
            ContextVideoSaver(os.path.join(args.save_dir, backend,
                                           f"{backend}.mp4"),
                              fps=BACKEND_VIDEO_FPS.get(backend, 10)),
        ]
        if args.batch_size > 1:
            run_depth_estimation_pipeline_batched(camera, pipeline,
                                                  args.batch_size, hooks)
        else:
            run_depth_estimation_pipeline(camera, pipeline, hooks)


if __name__ == "__main__":
    main()
