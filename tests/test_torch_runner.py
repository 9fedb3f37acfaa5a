"""The port's cameras, runners, hooks, ASGI app and entry points on the
CPU, against the JAX package where it has a counterpart: the KITTI camera
and the fixture evaluation on the committed drive, the Middlebury camera on
a scene written from a seed, the savers' files, and the ASGI contract of
``tests/test_serve.py``."""

import asyncio
import json
import os
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from stereo_tpu.core.config import PipelineConfig as JaxPipelineConfig
from stereo_tpu.pipeline import DepthEstimationPipeline as JaxPipeline
from stereo_tpu.pipeline import (
    run_depth_estimation_pipeline_evaluation as jax_evaluation)
from stereo_tpu.pipeline.camera import KittiSingleViewCamera as JaxKitti
from stereo_tpu.pipeline.camera import MiddleburyStereoCamera as JaxMiddlebury
from stereo_tpu.pipeline.hooks import DisparityMapSaver as JaxDisparitySaver
from stereo_tpu.pipeline.metrics import default_metrics as jax_metrics
from stereo_tpu.utils import image_io as JaxImageIo

from stereo_tpu_torch.core.config import MatchingConfig, PipelineConfig
from stereo_tpu_torch.pipeline import (
    DepthEstimationPipeline, DepthEstimationPipelineConfig,
    DepthEstimationPipelineContext, extract_config_from_camera,
    run_depth_estimation_pipeline, run_depth_estimation_pipeline_batched,
    run_depth_estimation_pipeline_evaluation,
    validate_pipeline_config_wrt_camera)
from stereo_tpu_torch.pipeline.camera import (Camera, KittiSingleViewCamera,
                                              MiddleburyStereoCamera,
                                              load_middlebury_calibration)
from stereo_tpu_torch.pipeline.hooks import (ContextFrameSaver,
                                             ContextVideoSaver,
                                             DisparityMapSaver, LambdaHook,
                                             PointCloudSaver)
from stereo_tpu_torch.pipeline.metrics import default_metrics
from stereo_tpu_torch.scripts import (evaluate_depth_estimation_pipeline,
                                      run_kitti_pipeline,
                                      run_middlebury_pipeline)
from stereo_tpu_torch.serve import DepthEstimationServer, create_asgi_app
from stereo_tpu_torch.synthesis import RightViewSynthesis
from stereo_tpu_torch.utils.image_io import read_video
from stereo_tpu_torch.utils.png import decode_png, encode_png
from stereo_tpu_torch.utils.pointcloud import read_ply
from stereo_tpu_torch.utils.profiling import device_trace

import torch_threads

torch_threads.take_worker_share()

FIXTURE_DRIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "fixtures", "kitti", "2011_09_26",
                             "2011_09_26_drive_0001_sync")
SHAPE = (48, 96)
MAX_DISPARITY = 16
CALIB = """cam0=[1758.23 0 953.34; 0 1758.23 552.29; 0 0 1]
cam1=[1758.23 0 953.34; 0 1758.23 552.29; 0 0 1]
doffs=0
baseline=111.53
width={w}
height={h}
ndisp=290
isint=0
vmin={vmin}
vmax={vmax}
dyavg=0
dymax=0
"""


def textured(rng, shape):
    """A smooth seeded RGB frame (blocks of 4 plus noise), integer-valued."""
    h, w = shape
    base = rng.uniform(0, 255, (3, h // 4 + 1, w // 4 + 1))
    up = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)[:, :h, :w]
    return np.clip(np.round(up + rng.uniform(-20, 20, up.shape)), 0,
                   255).astype(np.float32)


class PairCamera(Camera):
    """Seeded stereo pairs at ``SHAPE``: right = left rolled by 5 px."""

    def __init__(self, n=3, seed=0, with_right=True):
        rng = np.random.default_rng(seed)
        self.frames = [textured(rng, SHAPE) for _ in range(n)]
        self.with_right = with_right

    def focal_length(self):
        return 100.0

    def baseline(self):
        return 0.54

    def get_image_shape(self):
        return SHAPE

    def get_disparity_boundaries(self):
        return (0, MAX_DISPARITY)

    def stream_image_pairs(self):
        for left in self.frames:
            yield left, (np.roll(left, -5, axis=-1) if self.with_right
                         else None)


def write_scene(directory, seed=0, shape=(40, 96), vmin=4, vmax=27):
    rng = np.random.default_rng(seed)
    left = textured(rng, shape)
    right = np.roll(left, -9, axis=-1)
    os.makedirs(directory, exist_ok=True)
    for name, image in (("im0.png", left), ("im1.png", right)):
        with open(os.path.join(directory, name), "wb") as f:
            f.write(encode_png(image.transpose(1, 2, 0).astype(np.uint8)))
    with open(os.path.join(directory, "calib.txt"), "w") as f:
        f.write(CALIB.format(w=shape[1], h=shape[0], vmin=vmin, vmax=vmax))
    return left, right


def small_pipeline(synthesis=None):
    config = PipelineConfig(image_shape=SHAPE, min_disparity=0,
                            max_disparity=MAX_DISPARITY)
    return DepthEstimationPipeline(config, synthesis=synthesis, device="cpu")


# --- cameras ---------------------------------------------------------------

def test_kitti_camera_frames_and_gt_equal_jax():
    cam = KittiSingleViewCamera(FIXTURE_DRIVE, return_right_view=True)
    jax_cam = JaxKitti(FIXTURE_DRIVE, return_right_view=True)
    assert len(cam) == 2
    assert cam.get_image_shape() == (384, 1280)
    assert cam.get_disparity_boundaries() == (0, 64)
    assert (cam.focal_length(), cam.baseline()) == (jax_cam.focal_length(),
                                                    jax_cam.baseline())
    triplets = list(cam.stream_image_pairs_with_gt_disparity())
    jax_triplets = list(jax_cam.stream_image_pairs_with_gt_disparity())
    assert len(triplets) == len(jax_triplets) == 2
    for (left, right, gt), (jl, jr, jgt) in zip(triplets, jax_triplets):
        assert left.shape == right.shape == (3, 384, 1280)
        assert left.dtype == np.float32 and gt.dtype == np.float32
        # Pad (left=19, top=5, right=19, bottom=4): zeros around the frame.
        assert np.all(left[:, :5] == 0) and np.all(left[:, 380:] == 0)
        assert np.all(left[:, :, :19] == 0) and np.all(left[:, :, 1261:] == 0)
        assert left[:, 5:380, 19:1261].std() > 1.0
        np.testing.assert_array_equal(left, jl)
        np.testing.assert_array_equal(right, jr)
        np.testing.assert_array_equal(gt, jgt)
        assert (gt > 0).sum() == 2
    single = KittiSingleViewCamera(FIXTURE_DRIVE, only_one=True)
    pairs = list(single.stream_image_pairs())
    assert len(single) == 1 and len(pairs) == 1 and pairs[0][1] is None


def test_middlebury_camera_equals_jax(tmp_path):
    scene = str(tmp_path / "scene")
    left, right = write_scene(scene)
    cam, jax_cam = MiddleburyStereoCamera(scene), JaxMiddlebury(scene)
    calib = load_middlebury_calibration(os.path.join(scene, "calib.txt"))
    assert (calib.width, calib.height, calib.vmin, calib.vmax) == (96, 40, 4,
                                                                   27)
    assert calib.get_focal_length() == jax_cam.calibration.get_focal_length()
    assert calib.get_principal_point() == \
        jax_cam.calibration.get_principal_point()
    assert cam.get_image_shape() == jax_cam.get_image_shape() == (40, 96)
    assert cam.get_disparity_boundaries() == (4, 27)
    assert (cam.focal_length(), cam.baseline()) == (jax_cam.focal_length(),
                                                    jax_cam.baseline())
    (got_l, got_r), = list(cam.stream_image_pairs())
    (want_l, want_r), = list(jax_cam.stream_image_pairs())
    np.testing.assert_array_equal(got_l, left)
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_array_equal(got_r, want_r)
    with pytest.raises(RuntimeError, match="not found"):
        MiddleburyStereoCamera(str(tmp_path / "missing"))


def test_extract_config_and_validation(tmp_path):
    scene = str(tmp_path / "scene")
    write_scene(scene)
    config = extract_config_from_camera(MiddleburyStereoCamera(scene))
    assert isinstance(config, DepthEstimationPipelineConfig)
    assert (config.image_shape, config.min_disparity,
            config.max_disparity) == ((40, 96), 4, 27)
    kitti = extract_config_from_camera(KittiSingleViewCamera(FIXTURE_DRIVE))
    assert (kitti.image_shape, kitti.min_disparity,
            kitti.max_disparity) == ((384, 1280), 0, 64)
    validate_pipeline_config_wrt_camera(kitti, KittiSingleViewCamera(
        FIXTURE_DRIVE))
    with pytest.raises(RuntimeError, match="Incompatible image shapes"):
        validate_pipeline_config_wrt_camera(config, KittiSingleViewCamera(
            FIXTURE_DRIVE))


# --- runners ---------------------------------------------------------------

def test_fixture_evaluation_equals_jax():
    """Classical backend, real right view: the inputs are integer-valued,
    where the classical stages agree, so the six metrics agree too."""
    cam = KittiSingleViewCamera(FIXTURE_DRIVE, return_right_view=True)
    config = extract_config_from_camera(cam).update(
        stereo_matching_backend="classical")
    got = run_depth_estimation_pipeline_evaluation(
        cam, DepthEstimationPipeline(config, device="cpu"), default_metrics())
    jax_cam = JaxKitti(FIXTURE_DRIVE, return_right_view=True)
    jax_config = JaxPipelineConfig(image_shape=(384, 1280), min_disparity=0,
                                   max_disparity=64)
    want = jax_evaluation(jax_cam, JaxPipeline(jax_config), jax_metrics())
    assert set(got) == {"D1", "Threshold_1", "Threshold_2", "Threshold_3",
                        "Threshold_5", "MAE"}
    for name in want:
        assert abs(got[name] - want[name]) <= 1e-6, (name, got, want)


def collect(store):
    return LambdaHook(lambda ctx: store.__setitem__(
        ctx.frame_index, ctx.disparity_map.cpu().numpy()))


@pytest.mark.parametrize("with_right", [True, False], ids=["pair", "rvs"])
def test_batched_runner_equals_per_frame(with_right):
    synthesis = RightViewSynthesis(output_shape=SHAPE, seed=0,
                                   model_full_shape=(128, 256),
                                   model_down_shape=(32, 64), device="cpu")
    pipeline = small_pipeline(synthesis)
    cam = PairCamera(n=3, with_right=with_right)
    per_frame, batched = {}, {}
    run_depth_estimation_pipeline(cam, pipeline, [collect(per_frame)])
    run_depth_estimation_pipeline_batched(cam, pipeline, 2,
                                          [collect(batched)])
    assert sorted(per_frame) == sorted(batched) == [0, 1, 2]
    for i in per_frame:
        assert per_frame[i].shape == SHAPE
        np.testing.assert_array_equal(batched[i], per_frame[i])
    if with_right:     # true disparity 5 away from the wrapped columns
        assert np.median(per_frame[0][:, 8:-8]) == 5.0


def test_hook_exception_surfaces():
    def explode(ctx):
        raise ValueError(f"hook failed on frame {ctx.frame_index}")

    for run in (lambda h: run_depth_estimation_pipeline(
                    PairCamera(n=2), small_pipeline(), h),
                lambda h: run_depth_estimation_pipeline_batched(
                    PairCamera(n=2), small_pipeline(), 2, h)):
        with pytest.raises(ValueError, match="hook failed on frame"):
            run([LambdaHook(explode)])


def test_savers_write_readable_files(tmp_path):
    cam = PairCamera(n=2)
    pipeline = small_pipeline()
    disparities = {}
    video = str(tmp_path / "video" / "clip.mp4")
    hooks = [collect(disparities),
             DisparityMapSaver(str(tmp_path / "disparity")),
             ContextFrameSaver(str(tmp_path / "context")),
             PointCloudSaver.for_camera(cam, str(tmp_path / "cloud"),
                                        invalid_disparity=-1.0),
             ContextVideoSaver(video, fps=5)]
    run_depth_estimation_pipeline(cam, pipeline, hooks)

    def files(sub):
        (folder,) = os.listdir(tmp_path / sub)    # one timestamped folder
        return sorted(os.path.join(tmp_path, sub, folder, f)
                      for f in os.listdir(tmp_path / sub / folder))

    disparity_pngs = files("disparity")
    assert [os.path.basename(p) for p in disparity_pngs] == [
        "disparity_map_000000.png", "disparity_map_000001.png"]
    # The same frame through the JAX package's saver: the same pixels.
    jax_dir = str(tmp_path / "jax")
    JaxDisparitySaver(jax_dir).process(SimpleNamespace(
        disparity_map=disparities[0], frame_index=0))
    (jax_folder,) = os.listdir(jax_dir)
    want = np.asarray(Image.open(os.path.join(
        jax_dir, jax_folder, "disparity_map_000000.png")))
    got = decode_png(open(disparity_pngs[0], "rb").read())
    np.testing.assert_array_equal(got, want)
    grid_h = 3 * SHAPE[0] + 4 * 10
    for path in files("context"):
        assert decode_png(open(path, "rb").read()).shape == (
            grid_h, SHAPE[1] + 20, 3)
    for i, path in enumerate(files("cloud")):
        points = read_ply(path)
        assert points.shape == (SHAPE[0] * SHAPE[1], 3)
        d = disparities[i].astype(np.float64).reshape(-1)
        with np.errstate(divide="ignore"):
            np.testing.assert_array_equal(points[:, 2], 0.54 * 100.0 / d)
    frames, fps = read_video(video)
    assert fps == 5 and frames.shape == (2, grid_h, SHAPE[1] + 20, 3)
    # Each frame of the lossy video is its context grid, within what the
    # JAX package's mp4 (OpenCV) of the same grids reaches, less 1 dB.
    from video_oracle import cv2_read, quality

    grids = np.stack([decode_png(open(path, "rb").read())
                      for path in files("context")])
    jax_video = str(tmp_path / "jax.mp4")
    JaxImageIo.write_video(jax_video, grids, fps=5)
    floor = quality(cv2_read(jax_video)[0], grids)["worst"] - 1.0
    assert quality(frames, grids)["worst"] >= floor


def test_video_saver_reorders_frames(tmp_path):
    """Hook tasks may finish out of order; the video is in frame order."""
    path = str(tmp_path / "clip.mp4")
    saver = ContextVideoSaver(path, fps=4)
    config = PipelineConfig(image_shape=(8, 12))
    images = {}
    for index in (2, 0, 1):
        image = torch.full((3, 8, 12), 50.0 * index)
        images[index] = image
        saver.process(DepthEstimationPipelineContext(
            disparity_map=image[0], left_image=image, right_image=image,
            config=config, frame_index=index))
    saver.on_pipeline_end()
    frames, _ = read_video(path)
    means = [float(frames[i, 10:18, 10:22].mean()) for i in range(3)]
    assert means == sorted(means) and len(set(means)) == 3


def test_device_trace_writes_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(path) as f:
        trace = json.load(f)
    assert any("mm" in str(e.get("name", "")) for e in trace["traceEvents"])


# --- ASGI ------------------------------------------------------------------

class StubPipeline:
    device = torch.device("cpu")

    def process(self, left, right=None):
        assert right is None                     # single-view contract
        return SimpleNamespace(disparity_map=left.mean(dim=0))


class ExplodingPipeline(StubPipeline):
    def process(self, left, right=None):
        raise RuntimeError("device fell over")


def call(app, method, body=b"", content_type=None):
    headers = ([(b"content-type", content_type.encode())]
               if content_type else [])
    scope = {"type": "http", "method": method, "path": "/",
             "headers": headers}
    messages = [{"type": "http.request", "body": body, "more_body": False}]
    sent = []

    async def receive():
        return messages.pop(0)

    async def send(message):
        sent.append(message)

    asyncio.run(app(scope, receive, send))
    return (sent[0]["status"], dict(sent[0]["headers"]),
            b"".join(m.get("body", b"") for m in sent[1:]))


def multipart(payload, boundary="xxASGIxx"):
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="file"; filename="left.png"\r\n'
            f"Content-Type: image/png\r\n\r\n").encode() + payload + \
        f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def stub_app(pipeline=None):
    config = PipelineConfig(image_shape=(16, 32), min_disparity=0,
                            max_disparity=8,
                            matching=MatchingConfig(height=16, width=32,
                                                    min_disparity=0,
                                                    max_disparity=8))
    return create_asgi_app(config, pipeline=pipeline or StubPipeline(),
                           device="cpu")


def upload(shape=(16, 32), seed=0):
    image = np.random.default_rng(seed).integers(0, 256, (*shape, 3),
                                                 dtype=np.uint8)
    return encode_png(image), image


def test_asgi_get_raw_and_multipart():
    app = stub_app()
    status, headers, body = call(app, "GET")
    assert status == 200 and headers[b"content-type"] == b"application/json"
    assert json.loads(body) == {"backend": "classical", "image_shape": [16, 32],
                                "device": "cpu"}
    data, image = upload()
    want = np.clip(np.round(image.astype(np.float32).mean(axis=2)), 0,
                   255).astype(np.uint8)
    status, headers, body = call(app, "POST", data, "image/png")
    assert status == 200 and headers[b"content-type"] == b"image/png"
    np.testing.assert_array_equal(decode_png(body)[..., 0], want)
    status, _, body = call(app, "POST", *multipart(data))
    assert status == 200
    np.testing.assert_array_equal(decode_png(body)[..., 0], want)


@pytest.mark.parametrize("method,body,ctype,status", [
    ("POST", b"not a png", None, 400),
    ("POST", b"--x\r\n\r\nno file\r\n--x--", "multipart/form-data; boundary=x",
     400),
    ("DELETE", b"", None, 405),
], ids=["bad_payload", "no_file_field", "wrong_method"])
def test_asgi_errors(method, body, ctype, status):
    got, headers, reply = call(stub_app(), method, body, ctype)
    assert got == status
    assert headers[b"content-type"] == b"application/json"
    assert b"error" in reply


def test_asgi_pipeline_fault_is_500():
    status, _, body = call(stub_app(ExplodingPipeline()), "POST", upload()[0])
    assert status == 500 and b"device fell over" in body


def test_asgi_reply_equals_http_server_reply():
    """A real CPU pipeline behind both surfaces: the same upload (another
    size, resized by the server) gives the same PNG bytes."""
    synthesis = RightViewSynthesis(output_shape=SHAPE, seed=0,
                                   model_full_shape=(128, 256),
                                   model_down_shape=(32, 64), device="cpu")
    pipeline = small_pipeline(synthesis)
    config = pipeline.get_configuration()
    data, _ = upload((61, 133), seed=1)
    server = DepthEstimationServer(config, pipeline=pipeline, device="cpu")
    host, port = server.start("127.0.0.1", 0)
    try:
        req = urllib.request.Request(f"http://{host}:{port}/", data=data,
                                     headers={"Content-Type": "image/png"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            http_reply = resp.read()
    finally:
        server.shutdown()
    status, _, asgi_reply = call(create_asgi_app(config, pipeline=pipeline,
                                                 device="cpu"),
                                 "POST", data, "image/png")
    assert status == 200 and asgi_reply == http_reply
    assert decode_png(asgi_reply).shape == (*SHAPE, 1)


# --- entry points ----------------------------------------------------------

def test_synthetic_evaluation_names_the_roadmap_item(capsys):
    """``--synthetic`` is ported (ROADMAP section 1, item 4, training): it
    parses with the JAX script's defaults, the accuracy record's protocol;
    without it the drives are required."""
    args = evaluate_depth_estimation_pipeline.parse_args(["--synthetic"])
    assert (args.seed, args.n_frames, args.image_shape) == (
        20260817, 8, [384, 1280])
    assert args.backends == ["classical", "gwcnet", "msnet3d"]
    with pytest.raises(SystemExit):
        evaluate_depth_estimation_pipeline.parse_args([])
    assert "--synthetic" in capsys.readouterr().err


def test_synthetic_evaluation_runs_on_the_cpu(tmp_path):
    """One generated frame at 64x128 through the classical arm with the
    real right view: the six metrics, finite, written as JSON."""
    results = evaluate_depth_estimation_pipeline.main(
        ["--synthetic", "--n-frames", "1", "--image-shape", "64", "128",
         "--backends", "classical", "--rvs", "off", "--output-dir",
         str(tmp_path), "--device", "cpu"])
    assert set(results) == {"synthetic/rvs_off/classical"}
    metrics = results["synthetic/rvs_off/classical"]
    assert len(metrics) == 6 and all(np.isfinite(v) for v in metrics.values())
    assert 0.0 <= metrics["D1"] <= 1.0


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    scene = str(tmp_path / "scene")
    write_scene(scene)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (
            lambda: create_asgi_app(PipelineConfig()),
            lambda: evaluate_depth_estimation_pipeline.main(
                ["--drive-dirs", FIXTURE_DRIVE, "--backends", "classical",
                 "--output-dir", str(tmp_path / "eval")]),
            lambda: run_kitti_pipeline.main(
                ["--drive-dir", FIXTURE_DRIVE, "--backends", "classical",
                 "--save-dir", str(tmp_path / "kitti")]),
            lambda: run_middlebury_pipeline.main(
                ["--middlebury-dir", scene, "--save-dir",
                 str(tmp_path / "mb")])):
        with pytest.raises(RuntimeError, match="is_available"):
            run()


def test_scripts_run_on_the_cpu(tmp_path):
    scene = str(tmp_path / "scenes" / "seeded")
    write_scene(scene)
    run_middlebury_pipeline.main(["--middlebury-dir",
                                  str(tmp_path / "scenes"), "--save-dir",
                                  str(tmp_path / "mb"), "--device", "cpu"])
    (folder,) = os.listdir(tmp_path / "mb" / "seeded")
    names = sorted(os.listdir(tmp_path / "mb" / "seeded" / folder))
    assert names == ["context_frame_000000.png", "disparity_map_000000.png"]

    run_kitti_pipeline.main(["--drive-dir", FIXTURE_DRIVE, "--backends",
                             "classical", "--use-right-view", "--save-dir",
                             str(tmp_path / "kitti"), "--device", "cpu"])
    frames, fps = read_video(str(tmp_path / "kitti" / "classical" /
                                 "classical.mp4"))
    assert fps == 30 and frames.shape == (2, 3 * 384 + 40, 1300, 3)

    results = evaluate_depth_estimation_pipeline.main(
        ["--drive-dirs", FIXTURE_DRIVE, "--backends", "classical", "--rvs",
         "off", "--only-one", "--output-dir", str(tmp_path / "eval"),
         "--device", "cpu"])
    (written,) = os.listdir(tmp_path / "eval")
    with open(tmp_path / "eval" / written) as f:
        assert json.load(f) == results
    assert set(results) == {"2011_09_26_drive_0001_sync/rvs_off/classical"}
