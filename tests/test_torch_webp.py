"""The port's WebP decoder (``stereo_tpu_torch/_native/webp.cc``) through
``utils.image_io.decode_image_rgb`` / ``decode_image`` / ``read_image_chw``,
the stereo trainer's ground truth (``Kitti2015StereoDataset.load``) and the
server's upload decode, against the JAX package, which reads WebP with PIL
(Pillow 12.1 on libwebp 1.6: every file through libwebp's
WebPAnimDecoder).

The files come from PIL (seeded samples and crops of the committed KITTI
frame): lossless RGB and RGBA with ``exact`` on and off, at methods that
choose each transform, palettes of 2, 4, 16 and 256 colours and the colour
cache (``_native.webp_lossless_tools`` says which tools each file used, and
one test holds the cases to all of them); lossy at qualities 1, 50, 90 and
100 and methods 0 and 6, with alpha; odd sizes from 1x1 to 375x1242 and
crops of the frame.  What PIL's ``save`` cannot choose comes from
``tests/webp_files.py``: ALPH chunks built by hand (raw and compressed,
each filter, the pre-processing bit) and animations whose first frame
sits at an offset, and, from libwebp's encoder with the options Pillow does
not pass on, the committed fixtures (``tests/fixtures/webp``: 1, 2, 4 and 8
token partitions, the simple and normal loop filters at each sharpness,
1-4 segments, libwebp's raw and compressed alpha under each alpha filter),
each held to its manifest and to the JAX package here; ICCP, EXIF and XMP
chunks (an EXIF Orientation is not applied, as PIL does not apply it to
WebP).  Every comparison
is exact (tolerance 0), the mode included.  Files PIL refuses are a
``BadRequestError`` and an HTTP 400; ``tests/webp_pil_agreement.py`` adds
thousands of damaged files.
"""

import hashlib
import io
import json
import os
import struct
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from stereo_tpu.serve.api import (
    decode_png_to_pipeline_image as jax_decode_upload)
from stereo_tpu.train.stereo_trainer import (
    Kitti2015StereoDataset as JaxKitti2015StereoDataset)
from stereo_tpu.utils import image_io as jax_image_io

from stereo_tpu_torch import _native
from stereo_tpu_torch.serve import decode_png_to_pipeline_image
from stereo_tpu_torch.train.stereo_trainer import (Kitti2015StereoDataset,
                                                   read_disparity)
from stereo_tpu_torch.utils import image_io
from stereo_tpu_torch.utils.png import BadRequestError, encode_png

import torch_threads
import webp_files as wf
from raster_pil import pil_decode

torch_threads.take_worker_share()

HERE = os.path.dirname(os.path.abspath(__file__))
FRAME = os.path.join(HERE, "fixtures", "kitti", "2011_09_26",
                     "2011_09_26_drive_0001_sync", "image_02", "data",
                     "0000000000.png")
FIXTURES = os.path.join(HERE, "fixtures", "webp")
with open(os.path.join(FIXTURES, "expected.json")) as _f:
    MANIFEST = json.load(_f)
_cache = {}


def kitti() -> np.ndarray:
    if "kitti" not in _cache:
        with Image.open(FRAME) as im:
            _cache["kitti"] = np.asarray(im.convert("RGB"))
    return _cache["kitti"]


def crop(h: int, w: int, y: int = 100, x: int = 300) -> np.ndarray:
    return np.ascontiguousarray(kitti()[y:y + h, x:x + w])


def save(pixels: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(pixels)).save(buf, "WEBP", **kw)
    return buf.getvalue()


def with_alpha(rgb: np.ndarray, seed: int) -> np.ndarray:
    """``rgb`` with a seeded alpha plane: opaque and clear bands, noise
    elsewhere, so that the encoder's ``exact`` matters."""
    rng = np.random.default_rng(seed)
    alpha = rng.integers(0, 256, rgb.shape[:2]).astype(np.uint8)
    alpha[::5] = 255
    alpha[:, 1::7] = 0
    return np.dstack([rgb, alpha])


def pil_open(data: bytes):
    """PIL's mode and samples (``np.asarray`` of the image as opened)."""
    with Image.open(io.BytesIO(data)) as im:
        return im.mode, np.asarray(im)


def lossless_cases() -> dict:
    rng = np.random.default_rng(50)
    yy, xx = np.mgrid[:48, :64]
    colours = rng.integers(0, 256, (600, 3)).astype(np.uint8)
    content = {
        "kitti": crop(48, 64),
        "gradient": np.dstack([yy * 3, xx * 3, xx + yy]).astype(np.uint8),
        "mosaic": colours[rng.integers(0, 600, (48, 64))],
        "stripes": colours[(xx // 3 + yy * 7) % 300],
        "noise": rng.integers(0, 256, (48, 64, 3)).astype(np.uint8),
    }
    out = {}
    for name, rgb in content.items():
        for method in (0, 4, 6):
            out[f"lossless_{name}_m{method}"] = save(rgb, lossless=True,
                                                     method=method)
    for exact in (False, True):
        rgba = with_alpha(crop(48, 64), 51)
        out[f"lossless_rgba_exact{int(exact)}"] = save(rgba, lossless=True,
                                                       exact=exact)
        out[f"lossless_rgb_exact{int(exact)}"] = save(crop(48, 64, 20, 20),
                                                      lossless=True,
                                                      exact=exact)
    for colours_n in (2, 4, 16, 256):
        pal = rng.integers(0, 256, (colours_n, 3)).astype(np.uint8)
        out[f"lossless_palette{colours_n}"] = save(
            pal[rng.integers(0, colours_n, (37, 53))], lossless=True)
    return out


def lossy_cases() -> dict:
    out = {}
    for quality in (1, 50, 90, 100):
        for method in (0, 6):
            out[f"lossy_q{quality}_m{method}"] = save(
                crop(48, 64), quality=quality, method=method)
    out["lossy_rgba"] = save(with_alpha(crop(48, 64), 52), quality=80)
    out["lossy_rgba_q100"] = save(with_alpha(crop(48, 64), 53), quality=100)
    return out


def alpha_cases() -> dict:
    """Hand-built ALPH chunks: raw and VP8L-compressed, each filter; the
    pre-processing bit (PIL's decode leaves libwebp's dithering off)."""
    rgb = crop(40, 56)
    alpha = with_alpha(rgb, 54)[..., 3]
    lossy = save(rgb, quality=70)
    out = {}
    for compression in (0, 1):
        for method in range(4):
            out[f"alph_c{compression}_filter{method}"] = wf.with_alph(
                lossy, alpha, compression, method,
                lambda g: save(g, lossless=True))
    pre = bytearray(out["alph_c0_filter1"])
    pre[pre.index(b"ALPH") + 8] |= 1 << 4
    out["alph_c0_filter1_preprocessed"] = bytes(pre)
    return out


def animation_cases() -> dict:
    first = save(crop(40, 50), lossless=True)
    second = save(with_alpha(crop(30, 20, 50, 50), 55), quality=60)
    return {
        "anim_lossless_first_at_10_20": wf.animation(
            96, 80, [(10, 20, first), (0, 0, second)]),
        "anim_lossy_alpha_first_at_30_4": wf.animation(
            96, 80, [(30, 4, second), (0, 0, first)],
            background=(0, 255, 0, 255)),
        "anim_no_alpha_flag": wf.animation(64, 48, [(2, 2, second)],
                                           alpha=False),
        "anim_lossy_first_at_0_0": wf.animation(
            50, 40, [(0, 0, save(crop(40, 50), quality=50))]),
    }


def metadata_cases() -> dict:
    """ICCP, EXIF and XMP chunks (skipped); an EXIF Orientation of 6 is not
    applied: PIL does not apply it to a WebP when it loads one."""
    exif = Image.Exif()
    exif[0x0112] = 6
    rgb = crop(20, 30)
    return {"meta_exif_orientation6_lossless": save(
                rgb, lossless=True, exif=exif.tobytes()),
            "meta_iccp_exif_lossy": save(rgb, quality=80,
                                         exif=exif.tobytes(),
                                         icc_profile=bytes(range(200))),
            "meta_xmp_lossless": save(rgb, lossless=True, xmp=b"<x/>")}


def size_cases() -> dict:
    out = {}
    for h, w in ((1, 1), (1, 7), (7, 1), (2, 2), (3, 5), (17, 33),
                 (16, 16), (31, 47)):
        out[f"size_{h}x{w}_lossy"] = save(crop(h, w, 7, 11), quality=85)
        out[f"size_{h}x{w}_lossless"] = save(crop(h, w, 7, 11),
                                             lossless=True)
    out["size_375x1242_lossy"] = save(kitti(), quality=75)
    out["size_128x1242_lossless"] = save(kitti()[200:328], lossless=True)
    for y, x in ((0, 0), (101, 333), (374 - 63, 1241 - 95)):
        out[f"crop_{y}_{x}_lossy"] = save(crop(63, 95, y, x), quality=60)
    return out


def fixture_cases() -> dict:
    out = {}
    for name in MANIFEST["files"]:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            out["fixture_" + name[:-5]] = f.read()
    return out


def all_cases() -> dict:
    if "cases" not in _cache:
        cases = {}
        for make in (lossless_cases, lossy_cases, alpha_cases,
                     animation_cases, metadata_cases, size_cases,
                     fixture_cases):
            cases.update(make())
        _cache["cases"] = cases
    return _cache["cases"]


CASES = sorted(all_cases())


@pytest.mark.parametrize("name", CASES)
def test_reads_like_jax(tmp_path, name):
    """``read_image_chw`` and ``decode_image_rgb`` equal the JAX package's
    ``read_image_chw`` (PIL's ``convert("RGB")``) in every element,
    ``decode_image`` has PIL's mode and samples, and the trainer's ground
    truth equals JAX's reading of the file."""
    data = all_cases()[name]
    path = str(tmp_path / "image.webp")
    with open(path, "wb") as f:
        f.write(data)
    want = jax_image_io.read_image_chw(path)
    got = image_io.read_image_chw(path)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        image_io.decode_image_rgb(data).transpose(2, 0, 1), want)
    mode, samples = pil_open(data)
    decoded = image_io.decode_image(data)
    assert decoded.mode == mode
    np.testing.assert_array_equal(decoded.samples, samples)
    _, want_disp = pil_decode(data)
    np.testing.assert_array_equal(read_disparity(path), want_disp)


def test_lossless_cases_use_every_tool():
    """The lossless cases, between them, use every transform, the colour
    cache and a meta-Huffman image."""
    used = set()
    for name in CASES:
        used.update(_native.webp_lossless_tools(all_cases()[name]))
    assert used == set(_native.WEBP_LOSSLESS_TOOLS)


@pytest.mark.parametrize("want", [
    {"partitions": 1}, {"partitions": 2}, {"partitions": 4},
    {"partitions": 8}, {"simple": 1}, {"simple": 0}, {"segments": 1},
    {"segments": 0}] + [{"simple": s, "sharpness": k} for s in (0, 1)
                        for k in range(8)], ids=str)
def test_lossy_fixtures_hold_each_header_variant(want):
    """Among the committed lossy fixtures are frames with 1, 2, 4 and 8
    token partitions, each loop filter at each sharpness, and segments on
    and off (read from their VP8 headers)."""
    found = []
    for name, data in fixture_cases().items():
        try:
            header = wf.vp8_header(data)
        except (KeyError, ValueError):
            continue
        if header["level"] and all(header[k] == v for k, v in want.items()):
            found.append(name)
    assert found


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_fixture_matches_its_manifest(name):
    """``expected.json`` holds PIL's decode of each committed file, its mode
    and the JAX trainer's ground truth of it; the port's decode equals
    them."""
    entry = MANIFEST["files"][name]
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    assert len(data) == entry["bytes"] < 256 * 1024
    want, want_disp = pil_decode(data)
    got = image_io.decode_image_rgb(data)
    assert list(got.shape) == entry["shape"] == list(want.shape)
    assert hashlib.sha256(want.tobytes()).hexdigest() == entry["sha256"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    decoded = image_io.decode_image(data)
    assert decoded.mode == entry["mode"] == pil_open(data)[0]
    disp = image_io.disparity_of(decoded)
    assert hashlib.sha256(np.ascontiguousarray(
        want_disp, np.float32).tobytes()).hexdigest() == entry[
            "disparity_sha256"]
    assert hashlib.sha256(disp.tobytes()).hexdigest() == entry[
        "disparity_sha256"]


def test_fixtures_stay_small():
    total = sum(e["bytes"] for e in MANIFEST["files"].values())
    assert total < 1024 * 1024


# --- the stereo trainer's ground truth ---------------------------------------

def ground_truth_files() -> dict:
    """Seeded disparities (whole pixels in 0..64, some missing) as the red
    channel of WebP files: the JAX trainer reads an RGB or RGBA file's red
    channel as the disparity."""
    rng = np.random.default_rng(56)
    disp = np.round(rng.uniform(0, 64, (40, 64))).astype(np.uint8)
    disp[rng.uniform(0, 1, disp.shape) < 0.3] = 0
    rgb = np.dstack([disp, rng.integers(0, 256, (40, 64, 2))]).astype(
        np.uint8)
    return {"lossless_rgb": save(rgb, lossless=True),
            "lossless_rgba": save(with_alpha(rgb, 57), lossless=True,
                                  exact=True),
            "lossy_rgb": save(rgb, quality=90)}


@pytest.mark.parametrize("kind", sorted(ground_truth_files()))
def test_dataset_loads_like_jax(tmp_path, kind):
    """``Kitti2015StereoDataset.load`` equals JAX's in every element for
    WebP views (lossy left, lossless right) and WebP ground truth, cropped
    at the same seeded corner."""
    def write(name, data):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        return path

    gt = write("disp.webp", ground_truth_files()[kind])
    left = write("l.webp", save(crop(40, 64, 60, 80), quality=80))
    right = write("r.webp", save(crop(40, 64, 60, 90), lossless=True))
    ours = Kitti2015StereoDataset([left], [right], [gt], crop=(24, 48))
    theirs = JaxKitti2015StereoDataset([left], [right], [gt], crop=(24, 48))
    for seed in range(3):
        got = ours.load(0, np.random.default_rng(seed))
        want = theirs.load(0, np.random.default_rng(seed))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


# --- refusals ----------------------------------------------------------------

def refused_files() -> dict:
    """Files PIL refuses, each a ``BadRequestError`` naming WebP."""
    lossy = save(crop(24, 32), quality=60)
    lossless = save(crop(24, 32), lossless=True)
    alph = alpha_cases()["alph_c0_filter0"]
    reserved = bytearray(alph)
    reserved[reserved.index(b"ALPH") + 8] |= 0x40
    huge_canvas = wf.animation(20000, 20000, [(0, 0, lossy)])
    return {
        "truncated_lossy": lossy[:-7],
        "truncated_lossless": lossless[:len(lossless) // 2],
        "riff_size_too_large": lossy[:4] + struct.pack(
            "<I", len(lossy)) + lossy[8:],
        "riff_size_too_small": lossy[:4] + struct.pack("<I", 4) + lossy[8:],
        "chunk_size_too_large": lossy[:16] + struct.pack(
            "<I", len(lossy)) + lossy[20:],
        "zero_payload": b"RIFF" + struct.pack("<I", 44) + b"WEBPVP8 "
                        + struct.pack("<I", 32) + bytes(32),
        "not_a_keyframe": lossy[:20] + bytes([lossy[20] | 1]) + lossy[21:],
        "bad_vp8_start_code": lossy[:23] + b"\0" + lossy[24:],
        "bad_vp8l_signature": lossless[:20] + b"\0" + lossless[21:],
        "frame_larger_than_canvas": wf.riff(wf.vp8x(16, 16),
                                            wf.image_chunk(lossy)),
        "alph_reserved_bits": bytes(reserved),
        "over_the_pixel_limit": huge_canvas,
        "unknown_first_chunk": b"RIFF" + struct.pack("<I", 20) + b"WEBPJUNK"
                               + struct.pack("<I", 4) + bytes(4),
    }


@pytest.mark.parametrize("name", sorted(refused_files()))
def test_files_pil_refuses_are_bad_requests(tmp_path, name):
    data = refused_files()[name]
    assert isinstance(pil_decode(data)[0], Exception)
    with pytest.raises(BadRequestError, match="WebP"):
        image_io.decode_image_rgb(data)
    with pytest.raises(BadRequestError, match="WebP"):
        image_io.decode_image(data)
    path = str(tmp_path / "refused.webp")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(Exception):
        jax_image_io.read_image_chw(path)
    with pytest.raises(BadRequestError, match="WebP"):
        image_io.read_image_chw(path)


@pytest.mark.parametrize("seed", range(4))
def test_damaged_files_decode_or_refuse_like_pil(seed):
    """Seeded damage of a few cases (``webp_files.DAMAGE``): where PIL
    decodes the file the port gives the same mode and samples, where it
    refuses the port refuses (``webp_pil_agreement.py`` runs thousands)."""
    rng = np.random.default_rng(100 + seed)
    pool = sorted(k for k in CASES if not k.startswith(
        ("size_375", "size_128", "fixture_kitti")))
    for _ in range(60):
        name = pool[int(rng.integers(len(pool)))]
        kind = wf.DAMAGE[int(rng.integers(len(wf.DAMAGE)))]
        data = wf.damaged(all_cases()[name], rng, kind)
        try:
            want = pil_open(data)
        except Exception:  # noqa: BLE001 - any refusal
            want = None
        try:
            got = image_io.decode_image(data)
        except BadRequestError:
            got = None
        if want is None:
            assert got is None, (name, kind)
        else:
            assert got is not None and got.mode == want[0], (name, kind)
            np.testing.assert_array_equal(got.samples, want[1])


# --- serving -----------------------------------------------------------------

SHAPE = (48, 96)


@pytest.mark.parametrize("kind", ["lossy", "lossless", "lossy_alpha"])
def test_upload_decode_equals_jax_and_the_png_of_its_pixels(kind):
    """At the pipeline's shape the upload tensor equals JAX's upload decode
    and the port's decode of a PNG of the same pixels."""
    px = crop(*SHAPE, 150, 500)
    data = {"lossy": save(px, quality=85),
            "lossless": save(px, lossless=True),
            "lossy_alpha": save(with_alpha(px, 58), quality=85)}[kind]
    rgb = image_io.decode_image_rgb(data)
    got = decode_png_to_pipeline_image(data, SHAPE, "cpu").numpy()
    np.testing.assert_array_equal(got, jax_decode_upload(data, SHAPE))
    np.testing.assert_array_equal(got, decode_png_to_pipeline_image(
        encode_png(rgb), SHAPE, "cpu").numpy())


@pytest.fixture(scope="module")
def server():
    from stereo_tpu_torch.core.config import PipelineConfig
    from stereo_tpu_torch.pipeline import DepthEstimationPipeline
    from stereo_tpu_torch.serve import DepthEstimationServer
    from stereo_tpu_torch.synthesis import RightViewSynthesis

    synthesis = RightViewSynthesis(output_shape=SHAPE, seed=0,
                                   model_full_shape=(128, 256),
                                   model_down_shape=(32, 64), device="cpu")
    config = PipelineConfig(image_shape=SHAPE, max_disparity=16)
    pipeline = DepthEstimationPipeline(config, synthesis=synthesis,
                                       device="cpu")
    srv = DepthEstimationServer(config, pipeline=pipeline, micro_batch=2,
                                device="cpu")
    host, port = srv.start("127.0.0.1", 0)
    yield f"http://{host}:{port}/"
    srv.shutdown()


def post(url: str, data: bytes, ctype: str = "image/webp"):
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read()


def test_http_route_serves_webp_and_answers_400(server):
    px = crop(61, 133, 150, 500)
    for data in (save(px, quality=85), save(px, lossless=True),
                 alpha_cases()["alph_c1_filter3"]):
        status, body = post(server, data)
        assert status == 200
        with Image.open(io.BytesIO(body)) as im:
            assert im.size == SHAPE[::-1]
    for name in ("truncated_lossy", "over_the_pixel_limit",
                 "alph_reserved_bits"):
        with pytest.raises(urllib.error.HTTPError) as err:
            post(server, refused_files()[name])
        assert err.value.code == 400
        assert b"WebP" in err.value.read()
