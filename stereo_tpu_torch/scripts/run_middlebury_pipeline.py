"""Run the classical pipeline over Middlebury scenes (port of
``scripts/run_middlebury_pipeline.py``).

    python -m stereo_tpu_torch.scripts.run_middlebury_pipeline \
        --middlebury-dir /data/middlebury/scenes

Each scene directory (``im0.png``, ``im1.png``, ``calib.txt``) runs through
the pipeline at its calibration's size and disparity range, with the
disparity and context-frame savers under ``--save-dir/<scene>/``.
"""

from __future__ import annotations

import argparse
import os

from stereo_tpu_torch.pipeline import (DepthEstimationPipeline,
                                       extract_config_from_camera,
                                       run_depth_estimation_pipeline)
from stereo_tpu_torch.pipeline.camera import MiddleburyStereoCamera
from stereo_tpu_torch.pipeline.hooks import (ContextFrameSaver,
                                             DisparityMapCompletionLogger,
                                             DisparityMapSaver)


def scene_dirs(root: str):
    if os.path.exists(os.path.join(root, "calib.txt")):
        return [root]
    return sorted(os.path.join(root, d) for d in os.listdir(root)
                  if os.path.exists(os.path.join(root, d, "calib.txt")))


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--middlebury-dir", required=True,
                        help="a scene dir or a directory of scene dirs")
    parser.add_argument("--save-dir", default="results/middlebury")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    for scene in scene_dirs(args.middlebury_dir):
        name = os.path.basename(os.path.normpath(scene))
        print(f"Processing scene: {name}")
        camera = MiddleburyStereoCamera(scene)
        config = extract_config_from_camera(camera)
        pipeline = DepthEstimationPipeline(config, device=args.device)
        run_depth_estimation_pipeline(camera, pipeline, [
            DisparityMapCompletionLogger(),
            DisparityMapSaver(os.path.join(args.save_dir, name)),
            ContextFrameSaver(os.path.join(args.save_dir, name)),
        ])


if __name__ == "__main__":
    main()
