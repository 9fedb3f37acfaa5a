"""The port's I/O layer against the JAX package on the same files and
seeded inputs: Velodyne ground truth, PLY export, image I/O and grids, the
native host runtime, and the PNG decoder on every filter type."""

import io
import os
import struct
import time
import zlib

import numpy as np
import pytest
from PIL import Image

from stereo_tpu import _native as jax_native
from stereo_tpu.utils import image_io as jax_image_io
from stereo_tpu.utils import pointcloud as jax_pointcloud
from stereo_tpu.utils import velodyne as jax_velodyne

from stereo_tpu_torch import _native
from stereo_tpu_torch.utils import image_io, pointcloud, png, velodyne

import torch_threads

torch_threads.take_worker_share()

FIXTURE_CALIB = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "fixtures", "kitti", "2011_09_26")
FIXTURE_DRIVE = os.path.join(FIXTURE_CALIB, "2011_09_26_drive_0001_sync")
FRAMES = [os.path.join(FIXTURE_DRIVE, side, "data", name)
          for side in ("image_02", "image_03")
          for name in ("0000000000.png", "0000000001.png")]
VELO_BINS = [os.path.join(FIXTURE_DRIVE, "velodyne_points", "data", name)
             for name in ("0000000000.bin", "0000000001.bin")]


# --- velodyne --------------------------------------------------------------

@pytest.mark.parametrize("name", ["calib_cam_to_cam.txt",
                                  "calib_velo_to_cam.txt"])
def test_read_calib_file_equals_jax(name):
    path = os.path.join(FIXTURE_CALIB, name)
    got, want = velodyne.read_calib_file(path), jax_velodyne.read_calib_file(path)
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], str):
            assert got[key] == want[key]
        else:
            np.testing.assert_array_equal(got[key], want[key])


def test_focal_length_baseline_equals_jax():
    assert (velodyne.get_focal_length_baseline(FIXTURE_CALIB)
            == jax_velodyne.get_focal_length_baseline(FIXTURE_CALIB))


@pytest.mark.parametrize("velo", VELO_BINS, ids=["frame0", "frame1"])
@pytest.mark.parametrize("vel_depth", [True, False])
def test_generate_depth_map_equals_jax(velo, vel_depth):
    got = velodyne.generate_depth_map(FIXTURE_CALIB, velo, (375, 1242),
                                      vel_depth=vel_depth)
    want = jax_velodyne.generate_depth_map(FIXTURE_CALIB, velo, (375, 1242),
                                           vel_depth=vel_depth)
    assert got.dtype == want.dtype and (got > 0).sum() == 2
    np.testing.assert_array_equal(got, want)


# --- point clouds ----------------------------------------------------------

def test_ply_bytes_equal_jax_and_read_back(tmp_path):
    rng = np.random.default_rng(0)
    depth = rng.uniform(1, 80, (12, 17))
    mask = rng.uniform(size=(12, 17)) > 0.3
    ours, theirs = tmp_path / "port.ply", tmp_path / "jax.ply"
    pointcloud.save_point_cloud_from_depth(depth, mask, str(ours))
    jax_pointcloud.save_point_cloud_from_depth(depth, mask, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    points = pointcloud.read_ply(str(ours))
    np.testing.assert_array_equal(points, pointcloud.depth_to_points(depth,
                                                                     mask))
    assert points.shape == (int(mask.sum()), 3)


# --- image I/O -------------------------------------------------------------

@pytest.mark.parametrize("path", FRAMES, ids=lambda p: "/".join(
    p.split(os.sep)[-3::2]))
def test_read_image_chw_equals_jax(path):
    got = image_io.read_image_chw(path)
    assert got.shape == (3, 375, 1242) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_image_io.read_image_chw(path))


def test_pad_and_grid_equal_jax():
    rng = np.random.default_rng(1)
    image = rng.uniform(0, 255, (3, 11, 19)).astype(np.float32)
    disparity = rng.uniform(0, 64, (11, 19)).astype(np.float32)
    np.testing.assert_array_equal(image_io.pad_image(image, 19, 5, 19, 4),
                                  jax_image_io.pad_image(image, 19, 5, 19, 4))
    np.testing.assert_array_equal(
        image_io.pad_image(disparity, 1, 2, 3, 4, fill=7.0),
        jax_image_io.pad_image(disparity, 1, 2, 3, 4, fill=7.0))
    images = [image, image[::-1].copy(), disparity]
    np.testing.assert_array_equal(
        image_io.make_image_grid(image_io.prepare_image_grid(images)),
        jax_image_io.make_image_grid(jax_image_io.prepare_image_grid(images)))


def test_save_image_grid_decodes_to_jax_pixels(tmp_path):
    rng = np.random.default_rng(2)
    images = [rng.uniform(0, 255, (3, 9, 14)).astype(np.float32),
              rng.uniform(0, 64, (9, 14)).astype(np.float32)]
    image_io.save_image_grid(images, str(tmp_path / "port.png"))
    jax_image_io.save_image_grid(images, str(tmp_path / "jax.png"))
    got = png.decode_png((tmp_path / "port.png").read_bytes())
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    np.testing.assert_array_equal(got, want)


def test_video_round_trip_keeps_frames_and_order(tmp_path):
    """write_video and read_video: an mp4 of MPEG-4 Part 2 (lossy: each
    frame within 1 dB of the worst frame of the JAX package's mp4 of the
    same frames, odd sizes cropped to even as OpenCV crops them), in
    order, at its fps; ftyp first, a 64-bit mdat, moov last with 64-bit
    chunk offsets (co64)."""
    from video_oracle import cv2_read, drive_frames, psnr, quality

    frames = drive_frames(3, 3, 7, 13)
    frames[1] //= 2                        # the frames' order is visible
    path = str(tmp_path / "clip.mp4")
    image_io.write_video(path, frames, fps=6)
    got, fps = image_io.read_video(path)
    assert fps == 6 and got.shape == (3, 6, 12, 3)
    jax_path = str(tmp_path / "jax.mp4")
    jax_image_io.write_video(jax_path, frames, fps=6)
    floor = quality(cv2_read(jax_path)[0], frames)["worst"] - 1.0
    for i, frame in enumerate(got):
        gate = [psnr(frame, f[:6, :12]) for f in frames]
        assert max(range(3), key=gate.__getitem__) == i
        assert gate[i] >= floor, (gate, floor)
    data = open(path, "rb").read()
    assert data[4:8] == b"ftyp" and data[8:12] == b"isom"
    size, kind, mdat = struct.unpack_from(">I4sQ", data, 28)
    assert (size, kind) == (1, b"mdat")
    moov = data[28 + mdat:]
    assert moov[4:8] == b"moov"
    assert struct.unpack_from(">I", moov)[0] == len(moov)
    assert b"co64" in moov and b"stco" not in moov and b"mp4v" in moov


# --- the native host runtime -----------------------------------------------

def jax_native_loaded(timeout: float = 60.0):
    """The JAX package's native library, loaded.  It builds in place under
    a fixed name without a lock, so a test process that runs beside
    others building it can find a half-written file, record a build error
    and fall back to NumPy.  Wait for the racing build and load again,
    bounded; then insist on the native code, so that native is compared
    with native and never quietly with the fallback."""
    deadline = time.monotonic() + timeout
    while not jax_native.available() and time.monotonic() < deadline:
        time.sleep(1.0)
        jax_native._build_error = None        # forget the failed attempt
    assert jax_native.available(), (
        f"stereo_tpu._native did not load: {jax_native.build_error()}")
    return jax_native


def test_native_resize_pool_gray_equal_jax_native():
    jax_native_loaded()
    rng = np.random.default_rng(4)
    chw = rng.uniform(0, 255, (3, 16, 24)).astype(np.float32)
    for shape in ((8, 12), (21, 37), (16, 24)):
        np.testing.assert_allclose(_native.resize_bilinear_chw(chw, *shape),
                                   jax_native.resize_bilinear_chw(chw, *shape),
                                   rtol=0, atol=1e-6)
    hw = rng.uniform(0, 255, (13, 17)).astype(np.float32)
    np.testing.assert_allclose(_native.mean_pool(hw, 4),
                               jax_native.mean_pool(hw, 4), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_native.rgb_to_gray(chw),
                               jax_native.rgb_to_gray(chw), rtol=0, atol=1e-6)
    hwc = rng.integers(0, 256, (7, 9, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        _native.hwc_to_padded_chw(hwc, pad=(1, 2, 3, 4)),
        jax_native.hwc_to_padded_chw(hwc, pad=(1, 2, 3, 4)))


def test_frame_prefetcher_keeps_order(tmp_path):
    rng = np.random.default_rng(5)
    frames, paths = [], []
    for i in range(7):
        frame = rng.integers(0, 256, (15, 21, 3)).astype(np.uint8)
        frames.append(frame)
        paths.append(str(tmp_path / f"f{i}.png"))
        with open(paths[-1], "wb") as f:
            f.write(png.encode_png(frame))
    with _native.FramePrefetcher(paths, pad=(1, 1, 1, 1), slots=3,
                                 threads=2) as prefetcher:
        outs = list(prefetcher)
    assert len(outs) == 7
    for frame, out in zip(frames, outs):
        np.testing.assert_array_equal(
            out[:, 1:16, 1:22], frame.astype(np.float32).transpose(2, 0, 1))
    missing = _native.FramePrefetcher([paths[0], str(tmp_path / "no.png")],
                                      slots=2, threads=1)
    next(missing)
    with pytest.raises(RuntimeError, match="native decode failed"):
        next(missing)
    missing.close()


# --- the PNG decoder (the repair: native, not a Python loop) ---------------

def _chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def filtered_png(image, ftypes):
    """8-bit PNG bytes of ``image`` (H, W, C) whose row y uses filter
    ``ftypes[y % len(ftypes)]``, filtered here with NumPy."""
    h, w, bpp = image.shape
    rows = image.reshape(h, w * bpp).astype(np.int64)
    out = bytearray()
    for y in range(h):
        ftype = ftypes[y % len(ftypes)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        p = left + up - upleft
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, upleft))
        pred = [np.zeros_like(cur), left, up, (left + up) // 2, paeth][ftype]
        out.append(ftype)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
    color = {1: 0, 3: 2, 4: 6}[bpp]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(bytes(out))) + _chunk(b"IEND", b""))


@pytest.fixture
def native_calls(monkeypatch):
    """Counts the calls of the native decoder's entry."""
    calls = []
    decode = _native.decode_png_hwc

    def counted(data):
        calls.append(len(data))
        return decode(data)

    monkeypatch.setattr(_native, "decode_png_hwc", counted)
    return calls


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("ftypes", [[0], [1], [2], [3], [4], [4, 3, 1, 0, 2]],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
def test_decode_png_every_filter_type(ftypes, channels, native_calls):
    rng = np.random.default_rng(10 * channels + ftypes[0])
    image = rng.integers(0, 256, (9, 13, channels)).astype(np.uint8)
    data = filtered_png(image, ftypes)
    got = png.decode_png(data)
    assert native_calls == [len(data)]
    np.testing.assert_array_equal(got, image)
    np.testing.assert_array_equal(png.decode_png_python(data), image)
    pil = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(got, pil.reshape(got.shape))


@pytest.mark.parametrize("path", FRAMES[:2], ids=["frame0", "frame1"])
def test_decode_png_fixture_frame(path, native_calls):
    """The committed frames are Paeth-filtered, as image libraries write
    them: the native decoder against the Python oracle and PIL."""
    data = open(path, "rb").read()
    got = png.decode_png(data)
    assert native_calls == [len(data)]
    assert got.shape == (375, 1242, 3)
    np.testing.assert_array_equal(got, png.decode_png_python(data))
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))


def test_decode_png_bad_filter_type_is_bad_request():
    image = np.zeros((4, 5, 3), np.uint8)
    data = filtered_png(image, [0])
    raw = bytearray(zlib.decompress(data[33 + 8:-12 - 4]))
    raw[0] = 9
    body = zlib.compress(bytes(raw))
    broken = data[:33] + _chunk(b"IDAT", body) + _chunk(b"IEND", b"")
    for decode in (png.decode_png, png.decode_png_python):
        with pytest.raises(png.BadRequestError):
            decode(broken)
