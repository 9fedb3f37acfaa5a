"""The port's context video (MPEG-4 Part 2 in MP4: ``_native/mpeg4.cc``,
``utils/mp4.py``, ``utils/image_io.py``) against the JAX package's, which
OpenCV writes: the same seeded frames through both writers, both files
decoded by OpenCV.  OpenCV is the oracle here only; the port reads its own
files with its own decoder."""

import os
import struct
from types import SimpleNamespace

import numpy as np
import pytest

from stereo_tpu.pipeline.hooks import ContextVideoSaver as JaxVideoSaver
from stereo_tpu.utils import image_io as jax_image_io

from stereo_tpu_torch import _native
from stereo_tpu_torch.pipeline.hooks import ContextVideoSaver
from stereo_tpu_torch.utils import image_io, mp4

import torch_threads
from video_oracle import cv2_read, drive_frames, psnr, quality

torch_threads.take_worker_share()

FIXTURE_DRIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "fixtures", "kitti", "2011_09_26",
                             "2011_09_26_drive_0001_sync")

# (height, width) of the frames: the context grid of a 48x96 pipeline
# (3 x 48 + 40 by 96 + 20), a size that is not a multiple of 16, an odd
# size (OpenCV and the port crop it to 174x110), and a KITTI grid.
SHAPES = {"grid_48x96": (184, 116), "not_16": (100, 150),
          "odd": (175, 111), "kitti_grid": (1192, 1300)}
SMALL = ["grid_48x96", "not_16", "odd"]

# The acceptance gates against the JAX package's file of the same frames.
MEAN_PSNR_SLACK_DB = 0.5
WORST_PSNR_SLACK_DB = 1.0
SIZE_RATIO_LIMIT = 3.0
DECODER_PSNR_DB = 40.0


def frames_of(name: str) -> np.ndarray:
    h, w = SHAPES[name]
    return drive_frames(seed=sum(map(ord, name)), n=3 if h > 1000 else 6,
                        height=h, width=w)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each shape's frames written by both packages at 5 fps, and each
    file as OpenCV reads it."""
    root = tmp_path_factory.mktemp("video")
    out = {}
    for name in SHAPES:
        frames = frames_of(name)
        paths = {}
        for package, io in (("jax", jax_image_io), ("port", image_io)):
            paths[package] = str(root / f"{name}_{package}.mp4")
            io.write_video(paths[package], frames, fps=5)
        out[name] = dict(frames=frames, paths=paths,
                         read={k: cv2_read(p) for k, p in paths.items()})
    return out


@pytest.mark.parametrize("name", SMALL)
def test_cv2_reads_the_port_file_as_the_jax_file(written, name):
    case = written[name]
    (jax_frames, jax_info), (port_frames, port_info) = (
        case["read"]["jax"], case["read"]["port"])
    h, w = SHAPES[name]
    assert port_info == jax_info
    assert (port_info["width"], port_info["height"]) == (w & ~1, h & ~1)
    assert port_info["frames"] == len(case["frames"]) == len(port_frames)
    assert port_info["fps"] == 5.0
    assert port_frames.shape == jax_frames.shape
    # OpenCV names the codec by libavcodec's tag for MPEG-4 Part 2; the
    # file's sample entry is the MP4 name of the stream.
    assert port_info["fourcc"] == b"FMP4"
    with open(case["paths"]["port"], "rb") as f:
        assert b"mp4v" in f.read()[-4096:]


@pytest.mark.parametrize("name", list(SHAPES))
def test_quality_and_size_against_the_jax_file(written, name):
    case = written[name]
    jax_q = quality(case["read"]["jax"][0], case["frames"])
    port_q = quality(case["read"]["port"][0], case["frames"])
    assert port_q["mean"] >= jax_q["mean"] - MEAN_PSNR_SLACK_DB, (port_q,
                                                                  jax_q)
    assert port_q["worst"] >= jax_q["worst"] - WORST_PSNR_SLACK_DB, (port_q,
                                                                     jax_q)
    sizes = {k: os.path.getsize(p) for k, p in case["paths"].items()}
    assert sizes["port"] <= SIZE_RATIO_LIMIT * sizes["jax"], sizes


@pytest.mark.parametrize("name", list(SHAPES))
def test_port_decoder_against_cv2(written, name, record_property):
    case = written[name]
    got, fps = image_io.read_video(case["paths"]["port"])
    want = case["read"]["port"][0]
    assert fps == 5 and got.shape == want.shape and got.dtype == np.uint8
    values = [psnr(a, b) for a, b in zip(got, want)]
    assert min(values) >= DECODER_PSNR_DB, values
    largest = int(np.abs(got.astype(np.int16) - want).max())
    record_property("max_abs_difference", largest)


def test_context_video_savers_agree(tmp_path):
    """The JAX saver and the port's, fed the same contexts out of order:
    the same frames in order, within the quality gate of each other."""
    rng = np.random.default_rng(11)
    h, w = 48, 96
    views = drive_frames(seed=12, n=4, height=h, width=w)
    contexts = []
    for index in range(4):
        left = views[index].transpose(2, 0, 1).astype(np.float32)
        right = np.roll(left, -3, axis=2)
        disparity = rng.uniform(0, 16, (h, w)).astype(np.float32)
        contexts.append(SimpleNamespace(left_image=left, right_image=right,
                                        disparity_map=disparity,
                                        frame_index=index))
    paths = {"jax": str(tmp_path / "jax.mp4"),
             "port": str(tmp_path / "port.mp4")}
    savers = {"jax": JaxVideoSaver(paths["jax"], fps=4),
              "port": ContextVideoSaver(paths["port"], fps=4)}
    for saver in savers.values():
        for index in (2, 0, 3, 1):
            saver.process(contexts[index])
        saver.on_pipeline_end()
    grids = np.stack([np.clip(jax_image_io.make_image_grid(
        jax_image_io.prepare_image_grid([c.left_image, c.right_image,
                                         c.disparity_map])) * 255.0 + 0.5,
        0, 255).astype(np.uint8).transpose(1, 2, 0) for c in contexts])
    decoded = {k: cv2_read(p)[0] for k, p in paths.items()}
    assert decoded["port"].shape == decoded["jax"].shape == grids.shape
    for k in decoded:        # each frame nearest its own grid: in order
        for i, frame in enumerate(decoded[k]):
            nearest = max(range(4), key=lambda j: psnr(frame, grids[j]))
            assert nearest == i, (k, i)
    jax_q, port_q = (quality(decoded[k], grids) for k in ("jax", "port"))
    assert port_q["mean"] >= jax_q["mean"] - MEAN_PSNR_SLACK_DB
    assert port_q["worst"] >= jax_q["worst"] - WORST_PSNR_SLACK_DB
    ours, _ = image_io.read_video(paths["port"])
    assert min(psnr(a, b) for a, b in zip(ours, decoded["port"])) >= \
        DECODER_PSNR_DB


def _port_file(tmp_path, n=3, h=32, w=48) -> str:
    path = str(tmp_path / "port.mp4")
    image_io.write_video(path, drive_frames(1, n, h, w), fps=6)
    return path


@pytest.mark.parametrize("cut", ["empty", "ftyp_only", "mdat_header",
                                 "inside_mdat", "inside_moov", "last_byte"])
def test_truncated_file_is_refused(tmp_path, cut):
    path = _port_file(tmp_path)
    data = open(path, "rb").read()
    moov = data.rindex(b"moov") - 4
    keep = {"empty": 0, "ftyp_only": 28, "mdat_header": 40,
            "inside_mdat": moov // 2, "inside_moov": moov + 100,
            "last_byte": len(data) - 1}[cut]
    with open(path, "wb") as f:
        f.write(data[:keep])
    with pytest.raises(ValueError, match="MP4"):
        image_io.read_video(path)


@pytest.mark.parametrize("kind", ["png", "jax_mp4", "avi", "text",
                                  "stco_for_co64"])
def test_foreign_file_is_refused(tmp_path, kind):
    path = str(tmp_path / "foreign.mp4")
    if kind == "png":
        jax_image_io.save_image_grid([np.zeros((3, 8, 8), np.float32)],
                                     str(tmp_path / "x.png"))
        os.replace(tmp_path / "x.png", path)
    elif kind == "jax_mp4":
        jax_image_io.write_video(path, drive_frames(2, 3, 32, 48), fps=6)
    elif kind == "avi":
        with open(path, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", 4) + b"AVI ")
    elif kind == "text":
        with open(path, "w") as f:
            f.write("not a video\n" * 10)
    else:
        data = bytearray(open(_port_file(tmp_path), "rb").read())
        at = data.rindex(b"co64")
        data[at:at + 4] = b"stco"
        with open(path, "wb") as f:
            f.write(data)
    with pytest.raises(ValueError, match="MP4"):
        image_io.read_video(path)


def test_file_layout(tmp_path):
    """ftyp, a 64-bit mdat, then moov with one mp4v track whose esds holds
    the encoder's VOS/VO/VOL and whose chunk offsets are 64-bit."""
    path = _port_file(tmp_path, n=4, h=30, w=46)
    data = open(path, "rb").read()
    assert data[4:12] == b"ftypisom"
    size, kind, large = struct.unpack_from(">I4sQ", data, 28)
    assert (size, kind) == (1, b"mdat")
    assert data[28 + large + 4:28 + large + 8] == b"moov"
    assert 28 + large + struct.unpack_from(">I", data, 28 + large)[0] == \
        len(data)
    track = mp4.read_track(path)
    assert (track.width, track.height, track.fps) == (46, 30, 6)
    assert len(track.sizes) == len(track.offsets) == 4
    assert track.config == _native.mp4v_config(46, 30, 6)
    assert track.config.hex().startswith(
        "000001b001000001b58913000001000000012000")
    moov = data[28 + large:]
    assert b"co64" in moov and b"stco" not in moov and b"stss" not in moov
    assert struct.pack(">I", mp4.timescale_of(6)) in moov


def test_chunk_offsets_past_4_gib(tmp_path):
    """The sample tables of a file past 4 GiB: 64-bit chunk offsets and
    sizes read back as written (the moov alone, its samples not written)."""
    writer = mp4.Mp4Writer(str(tmp_path / "big.mp4"), 16, 16, 30,
                           _native.mp4v_config(16, 16, 30))
    writer.offsets = [5 << 30, (5 << 30) + 1000, 9 << 30]
    writer.sizes = [1000, 2000, 3000]
    moov = writer._moov()
    writer.close()
    track = mp4._parse_moov(moov, 0, 10 << 30, "big.mp4")
    assert track.offsets == writer.offsets and track.sizes == writer.sizes
    assert track.fps == 30


def _vol(**fields) -> bytes:
    """A VOS/VO/VOL like the encoder's, with some VOL fields changed."""
    v = dict(type=1, shape=0, interlaced=0, obmc_disable=1, sprite=0,
             quant_type=0, resync_disable=1, partitioned=0)
    v.update(fields)
    bits = []

    def put(value, n):
        bits.extend((value >> (n - 1 - i)) & 1 for i in range(n))
    head = bytes.fromhex("000001b001000001b589130000010000000120")
    put(0, 1)
    put(v["type"], 8)
    put(1, 1), put(1, 4), put(1, 3), put(1, 4)
    put(1, 1), put(1, 2), put(1, 1), put(0, 1)
    put(v["shape"], 2)
    put(1, 1), put(6, 16), put(1, 1), put(0, 1), put(1, 1)
    put(32, 13), put(1, 1), put(16, 13), put(1, 1)
    put(v["interlaced"], 1), put(v["obmc_disable"], 1), put(v["sprite"], 1)
    put(0, 1), put(v["quant_type"], 1), put(1, 1), put(v["resync_disable"], 1)
    put(v["partitioned"], 1), put(0, 1)
    put(0, 1)
    while len(bits) % 8:
        put(1, 1)
    return head + bytes(int("".join(map(str, bits[i:i + 8])), 2)
                        for i in range(0, len(bits), 8))


def test_vol_builder_matches_the_encoder():
    assert _vol() == _native.mp4v_config(32, 16, 6)


@pytest.mark.parametrize("fields,reason", [
    (dict(shape=2), "rectangular"), (dict(interlaced=1), "interlaced"),
    (dict(quant_type=1), "quant_type 1"), (dict(sprite=1), "coding tool"),
    (dict(resync_disable=0), "coding tool"),
    (dict(obmc_disable=0), "coding tool"), (dict(type=17), "coding tool")])
def test_decoder_refuses_other_vol(fields, reason):
    encoder = _native.Mpeg4Encoder(32, 16, 6, qp=4)
    vop = encoder.encode(np.zeros((16, 32, 3), np.uint8), 0)
    assert _native.decode_mp4v(_vol(), vop).shape == (16, 32, 3)
    with pytest.raises(ValueError, match=reason):
        _native.decode_mp4v(_vol(**fields), vop)


def test_decoder_refuses_p_vop_and_damage(tmp_path):
    path = str(tmp_path / "jax.mp4")
    jax_image_io.write_video(path, drive_frames(3, 3, 32, 48), fps=6)
    data = open(path, "rb").read()
    config = data[data.index(b"\x00\x00\x01\xb0"):]
    second = data.index(b"\x00\x00\x01\xb6", data.index(b"\x00\x00\x01\xb6")
                        + 4)
    with pytest.raises(ValueError, match="I-VOP"):
        _native.decode_mp4v(config, data[second:second + 64])
    encoder = _native.Mpeg4Encoder(48, 32, 6, qp=4)
    vop = encoder.encode(drive_frames(3, 1, 32, 48)[0], 0)
    with pytest.raises(ValueError, match="truncated"):
        _native.decode_mp4v(encoder.config, vop[:len(vop) // 2])
    with pytest.raises(ValueError, match="no VOP"):
        _native.decode_mp4v(encoder.config, b"\x00" * 64)
    not_coded = bytearray(vop)
    not_coded[5] &= 0x7F           # vop_coded: 3 bits of time at 6 fps
    with pytest.raises(ValueError, match="not-coded"):
        _native.decode_mp4v(encoder.config, bytes(not_coded))


@pytest.mark.parametrize("args", [(31, 16, 6, 4), (32, 15, 6, 4),
                                  (32, 16, 0, 4), (32, 16, 6, 0),
                                  (32, 16, 6, 32)])
def test_encoder_refuses_arguments(args):
    with pytest.raises(ValueError, match="unsupported arguments"):
        _native.Mpeg4Encoder(*args)


def test_writer_refuses_a_frame_of_another_shape(tmp_path):
    writer = image_io.open_video_writer(str(tmp_path / "v.mp4"), 16, 32, 5)
    with pytest.raises(ValueError, match="frame shape"):
        writer.write(np.zeros((16, 30, 3), np.uint8))
    writer.release()


def _ieee_rand(n: int, low: int, high: int) -> np.ndarray:
    """The first n numbers of IEEE 1180's generator (its ``rand`` with
    ``randx`` from 1) in [-low, high], by jumping the LCG ahead in
    doubling strides."""
    mod, a, c = 1 << 31, 1103515245, 12345
    x = np.array([(a + c) % mod], np.uint64)
    step_a, step_c = a, c
    while len(x) < n:
        x = np.concatenate([x, (x * np.uint64(step_a) + np.uint64(step_c))
                            % np.uint64(mod)])
        step_a, step_c = step_a * step_a % mod, (step_a * step_c + step_c) % mod
    i = (x[:n] & np.uint64(0x7FFFFFFE)).astype(np.float64)
    return np.floor(i / 0x7FFFFFFF * (low + high + 1)).astype(np.int64) - low


@pytest.mark.parametrize("low,high", [(256, 255), (5, 5), (300, 300)])
@pytest.mark.parametrize("sign", [1, -1])
def test_idct_meets_ieee_1180(low, high, sign):
    """IEEE 1180-1990 on 10000 blocks: the peak, per-pixel and overall
    errors of the decoder's IDCT against the double-precision one."""
    blocks = sign * _ieee_rand(10000 * 64, low, high).reshape(-1, 8, 8)
    k = np.arange(8)
    c = np.sqrt(2 / 8) * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    c[0] /= np.sqrt(2)
    coef = np.clip(np.round(c @ blocks @ c.T), -2048, 2047)
    want = np.clip(np.round(c.T @ coef @ c), -256, 255)
    got = _native.mp4v_idct(coef.astype(np.int32), -256, 255)
    err = (got - want).astype(np.float64)
    assert np.abs(err).max() <= 1
    assert (err ** 2).mean(axis=0).max() <= 0.06
    assert (err ** 2).mean() <= 0.02
    assert np.abs(err.mean(axis=0)).max() <= 0.015
    assert abs(err.mean()) <= 0.0015
    zero = _native.mp4v_idct(np.zeros((1, 8, 8), np.int32), -256, 255)
    assert not zero.any()


def test_long_stream_counts_every_frame(tmp_path):
    """A stream longer than one second of time base and longer than a
    modulo step: every frame in stsz, the last decoded within the gate."""
    frames = drive_frames(4, 40, 32, 48)
    path = str(tmp_path / "long.mp4")
    image_io.write_video(path, frames, fps=3)
    track = mp4.read_track(path)
    assert len(track.sizes) == 40 and track.fps == 3
    got, fps = image_io.read_video(path)
    want, info = cv2_read(path)
    assert info["frames"] == 40 and len(want) == 40
    assert min(psnr(a, b) for a, b in zip(got, want)) >= DECODER_PSNR_DB


def test_smoke_video_floor_is_the_jax_file_less_1_db(tmp_path):
    """``chip_smoke.VIDEO_PSNR_FLOOR_DB``: the worst frame of the JAX
    package's mp4 of the fixture drive's context grids (the KITTI run with
    its real right view, classical backend, on the CPU), less 1 dB, or
    lower (it is the lowest over the right views of
    ``tests/video_floor.py``)."""
    import chip_smoke
    from video_floor import fixture_grids

    grids = fixture_grids(FIXTURE_DRIVE, right_view="real")
    path = str(tmp_path / "jax.mp4")
    jax_image_io.write_video(path, grids, fps=30)
    worst = quality(cv2_read(path)[0], grids)["worst"]
    assert chip_smoke.VIDEO_PSNR_FLOOR_DB <= worst - 1.0
    assert chip_smoke.VIDEO_PSNR_FLOOR_DB >= worst - 1.5
    port = str(tmp_path / "port.mp4")
    image_io.write_video(port, grids, fps=30)
    ours, _ = image_io.read_video(port)
    assert quality(ours, grids)["worst"] >= chip_smoke.VIDEO_PSNR_FLOOR_DB
