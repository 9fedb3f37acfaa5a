"""The port's JPEG decoder (``stereo_tpu_torch/_native/jpeg.cc``, through
``utils.image_io.decode_image_rgb`` and ``read_image_chw``) against the
JAX package's ``read_image_chw``, which reads image files with PIL
(``convert("RGB")`` on libjpeg-turbo).

PIL writes the files from seeded numpy pixels or a crop of the committed
KITTI frame: noise, smooth gradients, flat fields; every subsampling,
baseline, progressive and optimized, qualities 1-100, restart markers,
grey and CMYK, APP segments, odd and long sizes.  Sampling factors PIL
does not write (h1v2, 4:1:1, 3:1, 4x4, ...) and blocks no 8-bit image
gives come from a small baseline writer here that Huffman-codes seeded
quantized coefficients with the standard tables.  Decoding is integer
arithmetic, so every comparison is exact (tolerance 0): block smoothing
of progressive files that lack their last scans, damaged streams, files
missing their EOI.  Files PIL refuses are a ``BadRequestError`` naming
JPEG, and the formats the port does not decode are refused by name.
"""

import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from stereo_tpu.train.stereo_trainer import (
    Kitti2015StereoDataset as JaxKitti2015StereoDataset)
from stereo_tpu.utils import image_io as jax_image_io

from stereo_tpu_torch.train.stereo_trainer import Kitti2015StereoDataset
from stereo_tpu_torch.utils import image_io
from stereo_tpu_torch.utils.image_io import decode_image_rgb
from stereo_tpu_torch.utils.png import BadRequestError, encode_png

import torch_threads

torch_threads.take_worker_share()

HERE = os.path.dirname(os.path.abspath(__file__))
FRAME = os.path.join(HERE, "fixtures", "kitti", "2011_09_26",
                     "2011_09_26_drive_0001_sync", "image_02", "data",
                     "0000000000.png")
FIXTURES = os.path.join(HERE, "fixtures", "jpeg")
with open(os.path.join(FIXTURES, "expected.json")) as _f:
    MANIFEST = json.load(_f)
_frame = []


def kitti_frame() -> np.ndarray:
    """The committed KITTI frame, (375, 1242, 3) uint8."""
    if not _frame:
        with Image.open(FRAME) as im:
            _frame.append(np.asarray(im.convert("RGB")))
    return _frame[0]


def pixels(kind: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    """(h, w, 3) uint8: seeded noise, a smooth gradient, a flat field or a
    crop of the KITTI frame."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), np.uint8)
    if kind == "gradient":
        y, x = np.mgrid[0:h, 0:w]
        lo = rng.integers(0, 64, 3)
        return np.stack([lo[0] + x * 191 // max(w - 1, 1),
                         lo[1] + y * 191 // max(h - 1, 1),
                         lo[2] + (x + y) * 95 // max(h + w - 2, 1)],
                        -1).astype(np.uint8)
    if kind == "flat":
        return np.broadcast_to(rng.integers(0, 256, 3, np.uint8),
                               (h, w, 3)).copy()
    frame = kitti_frame()
    y0 = int(rng.integers(0, frame.shape[0] - h + 1))
    x0 = int(rng.integers(0, frame.shape[1] - w + 1))
    return np.ascontiguousarray(frame[y0:y0 + h, x0:x0 + w])


def jpeg(image: np.ndarray, mode: str = "RGB", **save) -> bytes:
    im = Image.fromarray(image)
    if mode != "RGB":
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "JPEG", **save)
    return buf.getvalue()


def assert_reads_like_jax(tmp_path, data: bytes) -> np.ndarray:
    """The file read by both packages' ``read_image_chw``: equal in every
    element; the upload decode gives the same pixels."""
    path = str(tmp_path / "image.jpg")
    with open(path, "wb") as f:
        f.write(data)
    want = jax_image_io.read_image_chw(path)
    got = image_io.read_image_chw(path)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    rgb = image_io.decode_image_rgb(data)
    np.testing.assert_array_equal(rgb.transpose(2, 0, 1), want)
    # PIL's mode and samples ("L", "RGB" or "CMYK"), which the stereo
    # trainer's ground truth reads, convert to the same pixels.
    image = image_io.decode_image(data)
    with Image.open(io.BytesIO(data)) as im:
        assert image.mode == im.mode
        samples = np.asarray(im)
    np.testing.assert_array_equal(image.samples.reshape(samples.shape),
                                  samples)
    np.testing.assert_array_equal(image_io.convert_rgb(image), rgb)
    return rgb


def pil_refuses(data: bytes) -> bool:
    try:
        with Image.open(io.BytesIO(data)) as im:
            im.convert("RGB")
    except Exception:  # noqa: BLE001 - any refusal
        return True
    return False


def segments(data: bytes):
    """(offset, marker, length) of the segments up to the first SOS."""
    pos = 2
    while True:
        marker, length = data[pos + 1], struct.unpack(">H", data[pos + 2:
                                                                 pos + 4])[0]
        yield pos, marker, length
        if marker == 0xDA:
            return
        pos += 2 + length


def without_segment(data: bytes, marker: int) -> bytes:
    for pos, m, length in segments(data):
        if m == marker:
            return data[:pos] + data[pos + 2 + length:]
    raise AssertionError(f"no marker {marker:#x}")


def sof_offset(data: bytes) -> int:
    return next(pos for pos, m, _ in segments(data) if m in (0xC0, 0xC2))


# --- files PIL writes ---------------------------------------------------------

CODINGS = {"baseline": {}, "progressive": {"progressive": True},
           "optimize": {"optimize": True}}


@pytest.mark.parametrize("quality", [1, 50, 90, 100])
@pytest.mark.parametrize("coding", list(CODINGS))
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("kind", ["noise", "gradient", "flat", "kitti"])
def test_pil_files_read_like_jax(tmp_path, kind, subsampling, coding,
                                 quality):
    data = jpeg(pixels(kind, 37, 53, seed=quality), quality=quality,
                subsampling=subsampling, **CODINGS[coding])
    assert_reads_like_jax(tmp_path, data)


@pytest.mark.parametrize("subsampling", [0, 2])
@pytest.mark.parametrize("coding", ["baseline", "progressive"])
@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 3},
                                     {"restart_marker_rows": 1}],
                         ids=["blocks", "rows"])
def test_restart_markers_read_like_jax(tmp_path, restart, coding,
                                       subsampling):
    data = jpeg(pixels("kitti", 37, 53, seed=3), quality=90,
                subsampling=subsampling, **CODINGS[coding], **restart)
    assert b"\xff\xdd" in data[:data.index(b"\xff\xda")]
    assert_reads_like_jax(tmp_path, data)


@pytest.mark.parametrize("coding", ["baseline", "progressive"])
@pytest.mark.parametrize("mode", ["L", "CMYK"])
def test_grey_and_cmyk_read_like_jax(tmp_path, mode, coding):
    data = jpeg(pixels("kitti", 37, 53, seed=4), mode, quality=90,
                **CODINGS[coding])
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == mode
    rgb = assert_reads_like_jax(tmp_path, data)
    if mode == "L":
        assert (rgb == rgb[..., :1]).all()


def test_exif_orientation_is_not_applied(tmp_path):
    exif = Image.Exif()
    exif[0x0112] = 6
    data = jpeg(pixels("kitti", 37, 53, seed=5), quality=90,
                exif=exif.tobytes())
    assert assert_reads_like_jax(tmp_path, data).shape == (37, 53, 3)


def test_app1_thumbnail_is_not_the_image(tmp_path):
    """An APP1 holding a whole 16x16 JPEG is skipped by its length."""
    thumb = jpeg(pixels("noise", 16, 16, seed=6), quality=50)
    data = jpeg(pixels("kitti", 37, 53, seed=6), quality=90,
                exif=b"Exif\0\0" + bytes(8) + thumb)
    assert data.find(thumb) > 0
    assert assert_reads_like_jax(tmp_path, data).shape == (37, 53, 3)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("size", [(1, 1), (7, 9), (17, 31), (37, 53),
                                  (8, 2100), (375, 1242)], ids=str)
def test_sizes_read_like_jax(tmp_path, size, subsampling):
    h, w = size
    image = np.tile(pixels("kitti", h, min(w, 1242), seed=7),
                    (1, -(-w // 1242), 1))[:, :w]
    data = jpeg(image, quality=90, subsampling=subsampling)
    assert assert_reads_like_jax(tmp_path, data).shape == (h, w, 3)


def test_kitti_frame_at_quality_90(tmp_path):
    """The whole frame as a camera writes it: about 81 KB."""
    data = jpeg(kitti_frame(), quality=90)
    assert 60_000 < len(data) < 100_000
    assert_reads_like_jax(tmp_path, data)


def test_trailing_bytes_decode_as_pil(tmp_path):
    data = jpeg(pixels("kitti", 37, 53, seed=8), quality=90)
    assert_reads_like_jax(tmp_path, data + b"trailing \xff\xd8\xff bytes")


@pytest.mark.parametrize("variant", [
    "adobe_rgb", "rgb_ids", "ycck", "cmyk_no_adobe", "ycc_ids", "adobe_1"])
def test_colour_spaces_libjpeg_infers_read_like_jax(tmp_path, variant):
    """libjpeg's choice of colour space: an Adobe marker's transform (0:
    RGB, 2: YCCK, other: YCbCr or YCCK), else component ids 'R','G','B'
    for RGB, else YCbCr; four components without Adobe are CMYK."""
    crop = pixels("kitti", 37, 53, seed=9)
    if variant in ("adobe_rgb", "rgb_ids"):
        data = jpeg(crop, quality=90, keep_rgb=True)
        if variant == "rgb_ids":
            data = without_segment(data, 0xEE)
    elif variant == "ycc_ids":
        data = without_segment(jpeg(crop, quality=90), 0xE0)
    else:
        data = jpeg(crop, "CMYK", quality=90)
        if variant == "cmyk_no_adobe":
            data = without_segment(data, 0xEE)
        else:
            at = data.index(b"Adobe") + 11
            data = (data[:at] + bytes([2 if variant == "ycck" else 1])
                    + data[at + 1:])
    assert_reads_like_jax(tmp_path, data)


def scans_kept(data: bytes, n: int) -> bytes:
    """A progressive file with its first ``n`` scans and its EOI."""
    starts = [i for i in range(len(data) - 1)
              if data[i] == 0xFF and data[i + 1] == 0xDA]
    return data if n >= len(starts) else data[:starts[n]] + b"\xff\xd9"


@pytest.mark.parametrize("mode,subsampling,scans", [
    *(("RGB", sub, n) for sub in (2, 0) for n in range(1, 11)),
    *(("L", 0, n) for n in range(1, 7))],
    ids=lambda v: str(v))
def test_block_smoothing_reads_like_jax(tmp_path, mode, subsampling, scans):
    """A progressive file that lacks its last scans (the first scan alone:
    DC only, which libjpeg interpolates too) is smoothed as libjpeg
    smooths it; ten scans (six for grey) are the whole file."""
    full = jpeg(pixels("kitti", 41, 67, seed=10), mode, quality=75,
                subsampling=subsampling, progressive=True)
    assert full.count(b"\xff\xda") == (10 if mode == "RGB" else 6)
    assert_reads_like_jax(tmp_path, scans_kept(full, scans))


@pytest.mark.parametrize("damage", ["missing_rst", "wrong_rst", "flipped",
                                    "cut_with_eoi"])
def test_damaged_streams_read_like_jax(tmp_path, damage):
    """Damage libjpeg decodes through with a warning, which PIL ignores: a
    restart marker left out or out of order, a flipped byte, entropy data
    cut short before an EOI (the rest of the segment decodes as zeros)."""
    if damage == "cut_with_eoi":
        data = jpeg(kitti_frame(), quality=90)
        data = data[:len(data) // 2] + b"\xff\xd9"
    else:
        data = jpeg(pixels("kitti", 37, 53, seed=11), quality=90,
                    restart_marker_blocks=2)
        at = data.index(b"\xff\xd3")
        if damage == "missing_rst":
            data = data[:at] + data[at + 2:]
        elif damage == "wrong_rst":
            data = data[:at + 1] + b"\xd6" + data[at + 2:]
        else:
            sos = data.index(b"\xff\xda")
            data = data[:sos + 40] + bytes([data[sos + 40] ^ 0x5A]) \
                + data[sos + 41:]
    assert not pil_refuses(data)
    assert_reads_like_jax(tmp_path, data)


# --- sampling factors PIL does not write --------------------------------------

# Zigzag position -> natural (row-major) position.
NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
           12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
           35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
           58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
# Annex K.3's tables, as (bits per length 1..16, symbols).
DC_TABLES = [([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
             ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))]


def ac_table(lum: bool):
    """The standard AC tables, read from a file PIL writes with them."""
    buf = io.BytesIO()
    Image.new("RGB", (8, 8)).save(buf, "JPEG", quality=75)
    data = buf.getvalue()
    for pos, marker, length in segments(data):
        body = data[pos + 4:pos + 2 + length]
        while marker == 0xC4 and body:
            bits = list(body[1:17])
            n = sum(bits)
            if body[0] == (0x10 if lum else 0x11):
                return bits, list(body[17:17 + n])
            body = body[17 + n:]
    raise AssertionError("no AC table")


def huffman_codes(bits, symbols) -> dict:
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, length: int) -> None:
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def write_baseline(width, height, factors, coefs, qtables, restart=0):
    """A baseline JPEG of three components with sampling ``factors``
    [(h, v)] * 3 whose blocks hold ``coefs[c]`` ((rows, cols, 64) zigzag
    quantized coefficients): one interleaved scan when an MCU holds at most
    ten blocks, else one scan per component."""
    maxh, maxv = (max(f[i] for f in factors) for i in (0, 1))
    tq = [0, 1, 1]
    tables = [(huffman_codes(*DC_TABLES[t]), huffman_codes(*ac_table(t == 0)))
              for t in (0, 1)]
    out = bytearray(b"\xff\xd8")
    for t, q in enumerate(qtables):
        out += b"\xff\xdb" + struct.pack(">HB", 67, t) + bytes(q)
    for t in (0, 1):
        for cls, (bits, symbols) in ((0, DC_TABLES[t]), (1, ac_table(t == 0))):
            body = bytes([cls << 4 | t, *bits, *symbols])
            out += b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body
    out += b"\xff\xc0" + struct.pack(">HBHHB", 17, 8, height, width, 3)
    for c, (h, v) in enumerate(factors):
        out += bytes([c + 1, h << 4 | v, tq[c]])
    if restart:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart)
    interleaved = sum(h * v for h, v in factors) <= 10
    for scan in ([0, 1, 2],) if interleaved else ([0], [1], [2]):
        out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * len(scan), len(scan))
        for c in scan:
            out += bytes([c + 1, tq[c] << 4 | tq[c]])
        out += bytes([0, 63, 0])
        if len(scan) == 1:
            h, v = factors[scan[0]]
            mcus = [[(scan[0], y, x)]
                    for y in range(-(-height * v // (8 * maxv)))
                    for x in range(-(-width * h // (8 * maxh)))]
        else:
            mcus = [[(c, y * factors[c][1] + yy, x * factors[c][0] + xx)
                     for c in scan for yy in range(factors[c][1])
                     for xx in range(factors[c][0])]
                    for y in range(-(-height // (8 * maxv)))
                    for x in range(-(-width // (8 * maxh)))]
        bits, pred = BitWriter(), [0, 0, 0]
        for m, blocks in enumerate(mcus):
            if restart and m and m % restart == 0:
                out += bits.flush() + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
                bits, pred = BitWriter(), [0, 0, 0]
            for c, by, bx in blocks:
                block = coefs[c][by, bx]
                dc_codes, ac_codes = tables[tq[c]]
                diff = int(block[0]) - pred[c]
                pred[c] = int(block[0])
                size = abs(diff).bit_length()
                bits.put(*dc_codes[size])
                bits.put(diff if diff >= 0 else diff + (1 << size) - 1, size)
                nonzero = [k for k in range(1, 64) if block[k]]
                run = 0
                for k in range(1, (nonzero[-1] if nonzero else 0) + 1):
                    value = int(block[k])
                    if not value:
                        run += 1
                        continue
                    while run > 15:
                        bits.put(*ac_codes[0xF0])
                        run -= 16
                    size = abs(value).bit_length()
                    bits.put(*ac_codes[run << 4 | size])
                    bits.put(value if value > 0 else value + (1 << size) - 1,
                             size)
                    run = 0
                if not nonzero or nonzero[-1] < 63:
                    bits.put(*ac_codes[0x00])
        out += bits.flush()
    return bytes(out + b"\xff\xd9")


def seeded_coefficients(rng, factors, width, height, qtables):
    """Per component, (rows, cols, 64) zigzag coefficients over its whole
    block grid: DCs and a sparse spread of ACs, pixel-sized once
    dequantized."""
    maxh, maxv = (max(f[i] for f in factors) for i in (0, 1))
    coefs = []
    for c, (h, v) in enumerate(factors):
        q = np.asarray(qtables[0 if c == 0 else 1])
        rows = -(-height // (8 * maxv)) * v
        cols = -(-width // (8 * maxh)) * h
        block = np.zeros((rows, cols, 64), np.int64)
        block[..., 0] = rng.integers(-1000, 1000, (rows, cols)) // q[0]
        for k in range(1, 64):
            scale = 300 // (1 + k // 4)
            keep = rng.random((rows, cols)) < 0.4
            block[..., k] = np.where(keep, rng.integers(
                -scale, scale + 1, (rows, cols)) // q[k], 0)
        coefs.append(block)
    return coefs


@pytest.mark.parametrize("restart", [0, 2], ids=["plain", "restart2"])
@pytest.mark.parametrize("size", [(9, 7), (31, 17), (40, 3), (3, 40)],
                         ids=str)
@pytest.mark.parametrize("factors", [
    ((1, 2), (1, 1), (1, 1)), ((2, 1), (1, 2), (1, 1)),
    ((4, 1), (1, 1), (1, 1)), ((1, 4), (1, 1), (1, 1)),
    ((3, 1), (1, 1), (1, 1)), ((2, 4), (1, 2), (2, 1)),
    ((4, 4), (2, 2), (1, 1)), ((4, 2), (2, 2), (1, 2))],
    ids=lambda f: "_".join(f"{h}x{v}" for h, v in f))
def test_sampling_factors_read_like_jax(tmp_path, factors, size, restart):
    """h1v2 (the vertical triangle filter), h2v1 and h2v2 at other
    maxima, integral replication (4:1, 3:1, 4x4) and MCUs of more than ten
    blocks (one scan per component), with and without restarts."""
    width, height = size
    rng = np.random.default_rng(sum(sum(f) for f in factors) + width)
    qtables = [rng.integers(1, 16, 64).tolist(),
               rng.integers(1, 30, 64).tolist()]
    data = write_baseline(width, height, factors,
                          seeded_coefficients(rng, factors, width, height,
                                              qtables), qtables, restart)
    assert assert_reads_like_jax(tmp_path, data).shape == (height, width, 3)


@pytest.mark.parametrize("amplitude,quant_max,density,rows", [
    (20, 16, 0.5, 8), (300, 16, 0.5, 8), (1023, 255, 0.3, 8),
    (50, 255, 1.0, 8), (1023, 255, 0.6, 1)],
    ids=["mild", "dense", "wide", "full", "row0_only"])
def test_out_of_range_blocks_read_like_jax(tmp_path, amplitude, quant_max,
                                           density, rows):
    """Blocks no 8-bit image gives (a damaged or synthetic stream): the IDCT
    at the integer widths of libjpeg-turbo's x86 SIMD code, which PIL runs
    (16-bit products and sums, a saturated first pass, a saturated
    output), where jidctint.c's C code would wrap differently; ``row0_only``
    keeps rows 1-7 of every block zero (the SIMD code's DC-row shortcut)."""
    rng = np.random.default_rng(amplitude + rows)
    factors = ((1, 1), (1, 1), (1, 1))
    qtables = [rng.integers(1, quant_max, 64).tolist(),
               rng.integers(1, quant_max, 64).tolist()]
    natural_rows = np.array([NATURAL[k] // 8 for k in range(64)])
    coefs = []
    for _ in range(3):
        block = np.zeros((3, 4, 64), np.int64)
        block[..., 0] = rng.integers(-1023, 1024, (3, 4))
        for k in range(1, 64):
            if natural_rows[k] < rows:
                keep = rng.random((3, 4)) < density
                block[..., k] = np.where(keep, rng.integers(
                    -amplitude, amplitude + 1, (3, 4)), 0)
        coefs.append(block)
    data = write_baseline(32, 24, factors, coefs, qtables)
    assert_reads_like_jax(tmp_path, data)


def test_fractional_sampling_is_refused_like_jax():
    """libjpeg upsamples by integral ratios only: 3 against 2."""
    factors = ((3, 1), (2, 1), (1, 1))
    rng = np.random.default_rng(1)
    qtables = [[8] * 64, [8] * 64]
    data = write_baseline(24, 8, factors, seeded_coefficients(
        rng, factors, 24, 8, qtables), qtables)
    assert pil_refuses(data)
    with pytest.raises(BadRequestError, match="JPEG.*sampling"):
        decode_image_rgb(data)


# --- refusals -----------------------------------------------------------------

@pytest.mark.parametrize("damage", ["truncated_50", "truncated_98",
                                    "eoi_missing", "broken_sof"])
def test_files_pil_refuses_are_bad_requests_naming_jpeg(tmp_path, damage):
    data = jpeg(kitti_frame(), quality=90)
    if damage.startswith("truncated"):
        data = data[:len(data) * int(damage[-2:]) // 100]
    elif damage == "eoi_missing":
        assert data.endswith(b"\xff\xd9")
        data = data[:-2]
    else:
        at = sof_offset(data)
        data = data[:at + 3] + bytes([data[at + 3] + 3]) + data[at + 4:]
    assert pil_refuses(data)
    with pytest.raises(BadRequestError, match="JPEG"):
        image_io.decode_image_rgb(data)
    path = str(tmp_path / "broken.jpg")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match="JPEG"):
        image_io.read_image_chw(path)


@pytest.mark.parametrize("damage", ["tem", "short_jfif", "short_adobe"])
def test_headers_pils_parser_refuses_are_bad_requests(damage):
    """Markers libjpeg takes but PIL's own header parser refuses: a TEM
    marker, an APP0 "JFIF" or APP14 "Adobe" too short for its version."""
    data = jpeg(pixels("kitti", 16, 16, seed=13), quality=90)
    if damage == "tem":
        data = data[:2] + b"\xff\x01" + data[2:]
    elif damage == "short_jfif":
        data = without_segment(data, 0xE0)
        data = data[:2] + b"\xff\xe0\x00\x08JFIF\x00\x01" + data[2:]
    else:
        data = data[:2] + b"\xff\xee\x00\x08Adobe\x00" + data[2:]
    assert pil_refuses(data)
    with pytest.raises(BadRequestError, match="JPEG"):
        image_io.decode_image_rgb(data)


def pil_or_refusal(data: bytes):
    """PIL's ``convert("RGB")`` of the bytes, or None when PIL refuses
    them."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
    except Exception:  # noqa: BLE001 - any refusal
        return None


def assert_decodes_or_refuses_like_pil(data: bytes) -> bool:
    """The port decodes the bytes to PIL's pixels where PIL decodes them
    and refuses them (``BadRequestError`` naming JPEG) where PIL refuses;
    True when they decoded."""
    want = pil_or_refusal(data)
    if want is None:
        with pytest.raises(BadRequestError, match="JPEG"):
            decode_image_rgb(data)
        return False
    np.testing.assert_array_equal(decode_image_rgb(data), want)
    return True


def test_files_missing_their_eoi_decode_where_pil_decodes_them():
    """A single-scan file whose entropy data is whole needs no EOI in PIL
    when libjpeg never had to read past the last byte (PIL ignores
    ``jpeg_finish_decompress`` suspending); where libjpeg's refill (its
    fast or slow path, PIL's 64 KiB reads) reaches the end first, PIL says
    "image file is truncated".  Seeded crops, sizes, qualities, sampling
    and restart intervals, one or two bytes cut off: the port agrees on
    each, and both outcomes occur."""
    rng = np.random.default_rng(14)
    outcomes = []
    for _ in range(60):
        h, w = int(rng.integers(8, 376)), int(rng.integers(8, 1243))
        save = {"quality": int(rng.integers(30, 100)),
                "subsampling": int(rng.integers(0, 3))}
        if rng.random() < 0.3:
            save["restart_marker_blocks"] = int(rng.integers(1, 9))
        data = jpeg(pixels("kitti", h, w, seed=int(rng.integers(1 << 30))),
                    "L" if rng.random() < 0.25 else "RGB", **save)
        outcomes.append(assert_decodes_or_refuses_like_pil(
            data[:-int(rng.integers(1, 3))]))
    assert any(outcomes) and not all(outcomes)


@pytest.mark.parametrize("seed", range(6))
def test_mutated_files_decode_or_refuse_like_pil(seed):
    """Random byte changes, deletions and insertions in small baseline,
    progressive, restart-marked and optimized files, grey, RGB and CMYK:
    the port decodes what PIL decodes, to the same pixels, and refuses
    what PIL refuses (``tests/jpeg_pil_agreement.py`` runs thousands)."""
    rng = np.random.default_rng(100 + seed)
    crop = pixels("kitti", 40, 70, seed=seed)
    bases = [jpeg(crop, mode, quality=80, **save)
             for save in ({}, {"progressive": True},
                          {"subsampling": 0, "restart_marker_blocks": 2},
                          {"optimize": True, "subsampling": 1},
                          {"progressive": True, "restart_marker_rows": 1})
             for mode in ("RGB", "L", "CMYK")]
    for _ in range(50):
        data = bytearray(bases[int(rng.integers(len(bases)))])
        for _ in range(int(rng.integers(1, 4))):
            at, n = int(rng.integers(2, len(data))), int(rng.integers(1, 8))
            op = rng.integers(3)
            if op == 0:
                data[at] = int(rng.integers(256))
            elif op == 1:
                del data[at:at + n]
            else:
                data[at:at] = rng.integers(0, 256, n, np.uint8).tobytes()
        assert_decodes_or_refuses_like_pil(bytes(data))


@pytest.mark.parametrize("marker,reason", [
    (0xC9, "arithmetic"), (0xCA, "arithmetic"), (0xC3, "lossless"),
    (0xC5, "hierarchical"), (None, "8-bit")],
    ids=["sof9", "sof10", "sof3", "sof5", "12bit"])
def test_formats_not_decoded_are_refused_by_name(marker, reason):
    data = jpeg(pixels("kitti", 16, 16), quality=90)
    at = sof_offset(data)
    if marker is None:
        data = data[:at + 4] + b"\x0c" + data[at + 5:]
    else:
        data = data[:at + 1] + bytes([marker]) + data[at + 2:]
    with pytest.raises(BadRequestError, match=f"JPEG.*{reason}"):
        decode_image_rgb(data)


def test_other_formats_are_refused():
    # A WebP whose RIFF size and frame are zeros: PIL refuses it, and so
    # does the port's WebP decoder, by name.
    webp = b"RIFF" + bytes(4) + b"WEBPVP8 " + bytes(32)
    with pytest.raises(Exception):
        with Image.open(io.BytesIO(webp)) as im:
            im.load()
    with pytest.raises(BadRequestError, match="WebP"):
        image_io.decode_image_rgb(webp)
    with pytest.raises(BadRequestError, match="not a PNG, JPEG, BMP, TIFF"):
        image_io.decode_image_rgb(b"XYZW" + bytes(40))
    gif = b"GIF89a" + bytes(32)   # a GIF with no frame, which PIL refuses
    with pytest.raises(BadRequestError, match="GIF"):
        image_io.decode_image_rgb(gif)
    png = encode_png(pixels("noise", 5, 6))
    np.testing.assert_array_equal(image_io.decode_image_rgb(png),
                                  pixels("noise", 5, 6))


# --- the committed fixtures ----------------------------------------------------

@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_fixture_matches_its_manifest(name):
    """``expected.json`` holds PIL's decode of each committed file (so it
    cannot go stale) and the port's decode; the fixtures stay small."""
    entry = MANIFEST["files"][name]
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    assert len(data) == entry["bytes"] < 256 * 1024
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert("RGB"))
    got = decode_image_rgb(data)
    assert list(got.shape) == entry["shape"] == list(want.shape)
    assert hashlib.sha256(want.tobytes()).hexdigest() == entry["sha256"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]


def test_fixtures_stay_small():
    sizes = [os.path.getsize(os.path.join(FIXTURES, n))
             for n in os.listdir(FIXTURES)]
    assert max(sizes) < 256 * 1024 and sum(sizes) < 2 * 1024 * 1024


# --- the stereo trainer's dataset ---------------------------------------------

def test_kitti2015_dataset_over_jpeg_views_equals_jax(tmp_path):
    """Left and right views as JPEG, disparities as 16-bit PNG: the same
    triplets and batches in both packages from the same ``rng``."""
    rng = np.random.default_rng(12)
    lefts, rights, disps = [], [], []
    for i in range(3):
        for side, paths in (("left", lefts), ("right", rights)):
            path = str(tmp_path / f"{side}_{i}.jpg")
            with open(path, "wb") as f:
                f.write(jpeg(pixels("kitti", 48, 96, seed=20 + 2 * i
                                    + (side == "right")), quality=85,
                             subsampling=i % 3, progressive=i == 1))
            paths.append(path)
        path = str(tmp_path / f"disp_{i}.png")
        Image.fromarray(rng.integers(0, 64 * 256, (48, 96), np.uint16)).save(
            path)
        disps.append(path)
    ours = Kitti2015StereoDataset(lefts, rights, disps, crop=(32, 64))
    theirs = JaxKitti2015StereoDataset(lefts, rights, disps, crop=(32, 64))
    for i in range(3):
        for a, b in zip(ours.load(i, np.random.default_rng(i)),
                        theirs.load(i, np.random.default_rng(i))):
            np.testing.assert_array_equal(a, b)
    got, want = list(ours.batches(2, seed=4)), list(theirs.batches(2, seed=4))
    assert len(got) == len(want) == 1
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
