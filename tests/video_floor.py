"""The port's mp4 against the JAX package's (OpenCV's mp4v) on the same
frames, both decoded by OpenCV:

    JAX_PLATFORMS=cpu python tests/video_floor.py [--qp 3 4 5]

prints one JSON line per right view of the KITTI fixture drive's context
grids (the real one, Deep3D with the committed weights when
``data/checkpoints/deep3d.npz`` is present, and Deep3D with seeded
weights), then one per frame shape of ``tests/test_torch_video.py``
(``video_oracle.drive_frames``): each file's bytes and its mean and worst
frame's PSNR against its source, the port's at each quantiser asked for
(default: the writer's, ``image_io.VIDEO_QUANTISER``), with the port's
own decode of its file against OpenCV's (worst frame's PSNR, largest
difference).
``chip_smoke.VIDEO_PSNR_FLOOR_DB`` is the lowest worst frame of the JAX
files of the fixture drive less 1 dB; those grids are the ones the
smoke's ``runner`` phase writes (classical backend, 384x1280, padding 10).
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DRIVE = os.path.join(ROOT, "tests", "fixtures", "kitti",
                             "2011_09_26", "2011_09_26_drive_0001_sync")
DEEP3D_NPZ = os.path.join(ROOT, "data", "checkpoints", "deep3d.npz")


def fixture_grids(drive: str, right_view: str = "real") -> np.ndarray:
    """(T, 1192, 1300, 3) uint8 RGB: the grid ``ContextVideoSaver`` makes
    of each frame of ``drive`` through the port's classical pipeline on the
    CPU; ``right_view`` is "real", "deep3d_committed" or "deep3d_seeded"."""
    from stereo_tpu_torch.pipeline import (DepthEstimationPipeline,
                                           extract_config_from_camera,
                                           run_depth_estimation_pipeline)
    from stereo_tpu_torch.pipeline.camera import KittiSingleViewCamera
    from stereo_tpu_torch.pipeline.hooks import LambdaHook, to_host
    from stereo_tpu_torch.utils.image_io import (make_image_grid,
                                                 prepare_image_grid)

    synthesis = None
    if right_view != "real":
        from stereo_tpu_torch.synthesis import RightViewSynthesis

        committed = right_view == "deep3d_committed"
        synthesis = RightViewSynthesis(
            output_shape=(384, 1280),
            checkpoint_dir=DEEP3D_NPZ if committed else None,
            seed=None if committed else 0, device="cpu")
    camera = KittiSingleViewCamera(drive,
                                   return_right_view=right_view == "real")
    pipeline = DepthEstimationPipeline(extract_config_from_camera(camera),
                                       synthesis=synthesis, device="cpu")
    grids = {}

    def grab(ctx):
        grid = make_image_grid(prepare_image_grid([
            to_host(ctx.left_image), to_host(ctx.right_image),
            to_host(ctx.disparity_map)]), padding=10, pad_value=1.0)
        grids[ctx.frame_index] = np.clip(grid * 255.0 + 0.5, 0, 255).astype(
            np.uint8).transpose(1, 2, 0)

    run_depth_estimation_pipeline(camera, pipeline, [LambdaHook(grab)])
    return np.stack([grids[i] for i in sorted(grids)])


def main() -> None:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stereo_tpu.utils import image_io as jax_image_io
    from stereo_tpu_torch import _native
    from stereo_tpu_torch.utils import image_io
    from stereo_tpu_torch.utils.mp4 import Mp4Writer
    from test_torch_video import SHAPES, frames_of
    from video_oracle import cv2_read, quality

    parser = argparse.ArgumentParser()
    parser.add_argument("--qp", type=int, nargs="+",
                        default=[image_io.VIDEO_QUANTISER])
    args = parser.parse_args()
    cases = [("fixture_" + view, lambda v=view: (
        fixture_grids(FIXTURE_DRIVE, v), 30))
        for view in ("real", "deep3d_committed", "deep3d_seeded")
        if view != "deep3d_committed" or os.path.isfile(DEEP3D_NPZ)]
    cases += [(name, lambda n=name: (frames_of(n), 5)) for name in SHAPES]
    with tempfile.TemporaryDirectory() as tmp:
        for name, make in cases:
            frames, fps = make()
            path = os.path.join(tmp, "jax.mp4")
            jax_image_io.write_video(path, frames, fps=fps)
            jax_bytes = os.path.getsize(path)
            line = dict(case=name, shape=list(frames.shape), jax=dict(
                bytes=jax_bytes, **quality(cv2_read(path)[0], frames)))
            for qp in args.qp:
                # Mp4vWriter's steps at quantiser qp.
                path = os.path.join(tmp, f"port_{qp}.mp4")
                h, w = frames.shape[1] & ~1, frames.shape[2] & ~1
                encoder = _native.Mpeg4Encoder(w, h, fps, qp, 4)
                muxer = Mp4Writer(path, w, h, fps, encoder.config)
                for i, frame in enumerate(frames):
                    muxer.write(encoder.encode(frame[:h, :w, ::-1], i))
                muxer.close()
                decoded = cv2_read(path)[0]
                port = quality(decoded, frames)
                ours = image_io.read_video(path)[0]
                line[f"port_qp{qp}"] = dict(
                    decoder_vs_cv2_db_min=quality(ours, decoded)["worst"],
                    decoder_max_abs_diff=int(np.abs(
                        ours.astype(np.int16) - decoded).max()),
                    bytes=os.path.getsize(path),
                    bytes_ratio=os.path.getsize(path) / jax_bytes,
                    mean_gain_db=port["mean"] - line["jax"]["mean"],
                    worst_gain_db=port["worst"] - line["jax"]["worst"],
                    **port)
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
