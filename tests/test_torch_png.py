"""The port's PNG decoders on every colour type, bit depth and interlace
against PIL's ``convert("RGB")`` (what the JAX package reads images with),
through the three places that read images: the server's upload decode,
``utils.image_io.read_image_chw`` and the KITTI camera's ``_load_view``.

The PNGs are written here by an independent encoder (row packing, the five
filters and Adam7's passes), since PIL writes neither interlaced files nor
low bit depths of every colour type.  Every case is exact: decoding is
integer arithmetic, so the tolerance is 0.
"""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from stereo_tpu_torch import _native
from stereo_tpu_torch.pipeline.camera.kitti import KITTI_PAD
from stereo_tpu_torch.serve import (BadRequestError,
                                    decode_png_to_pipeline_image)
from stereo_tpu_torch.utils import image_io, png

import torch_threads

torch_threads.take_worker_share()

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def pack_row(values, depth):
    """One row of samples -> its bytes at ``depth`` bits per sample."""
    values = np.asarray(values, np.int64).reshape(-1)
    if depth == 16:
        return values.astype(">u2").tobytes()
    if depth == 8:
        return values.astype(np.uint8).tobytes()
    bits = ((values[:, None] >> np.arange(depth - 1, -1, -1)) & 1)
    return np.packbits(bits.reshape(-1).astype(np.uint8)).tobytes()


def filter_rows(rows, bpp, seed):
    """Filter each packed row with a filter type drawn from ``seed``: the
    forward filters, written independently of the decoders."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    prior = np.zeros(len(rows[0]), np.int64) if rows else None
    for row in rows:
        cur = np.frombuffer(row, np.uint8).astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        p = left + prior - upleft
        pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prior, upleft))
        ftype = int(rng.integers(0, 5))
        pred = [np.zeros_like(cur), left, prior, (left + prior) // 2,
                paeth][ftype]
        out.append(ftype)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prior = cur
    return bytes(out)


def make_png(samples, depth, color, interlace=False, palette=None,
             trns=None, seed=0):
    """(H, W, S) stored samples -> PNG bytes."""
    h, w, s = samples.shape
    bits = s * depth
    bpp = max(1, bits // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b""
    for i, (x0, y0, dx, dy) in enumerate(passes):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = [pack_row(r, depth) for r in sub]
        data += filter_rows(rows, bpp, seed + i)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace))
    body = chunk(b"IHDR", ihdr)
    if palette is not None:
        body += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        body += chunk(b"tRNS", trns.astype(np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n" + body + chunk(b"IDAT", zlib.compress(data))
            + chunk(b"IEND", b""))


def pil_rgb(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


# (colour type, bit depth, with tRNS): every kind the decoders add.
CASES = ([(0, d, False) for d in (1, 2, 4, 8, 16)]
         + [(3, d, t) for d in (1, 2, 4, 8) for t in (False, True)]
         + [(4, 8, False), (4, 16, False), (2, 16, False), (6, 16, False),
            (2, 8, False), (6, 8, False)])


def case_png(color, depth, trns, interlace, shape=(11, 13), seed=0):
    rng = np.random.default_rng(seed + 100 * color + depth)
    h, w = shape
    s = SAMPLES[color]
    palette = alpha = None
    if color == 3:
        n = min(2 ** depth, 40)
        palette = rng.integers(0, 256, (n, 3))
        alpha = rng.integers(0, 256, max(1, n // 2)) if trns else None
        samples = rng.integers(0, n, (h, w, 1))
    elif color == 0 and depth == 16:
        # Mostly small values: PIL clips 16-bit grey to 255 rather than
        # taking its high byte, and the small ones show that.
        samples = rng.integers(0, 400, (h, w, 1))
        samples[0, :4, 0] = [0, 255, 256, 65535]
    else:
        samples = rng.integers(0, 2 ** depth, (h, w, s))
    return make_png(samples, depth, color, interlace, palette, alpha,
                    seed=seed)


def case_id(case):
    color, depth, trns = case
    return f"c{color}d{depth}" + ("trns" if trns else "")


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_native_and_python_decode_like_pil(case, interlace):
    """The native decoder and its Python oracle give the same samples, and
    their RGB mapping equals PIL's ``convert("RGB")`` exactly."""
    data = case_png(*case, interlace)
    samples = png.decode_png(data)
    np.testing.assert_array_equal(samples, png.decode_png_python(data))
    want = pil_rgb(data)
    np.testing.assert_array_equal(png.decode_png_rgb(data), want)
    np.testing.assert_array_equal(png.rgb_like_pil(samples), want)


@pytest.mark.parametrize("shape", [(1, 1), (3, 2), (9, 17)],
                         ids=["1x1", "3x2", "9x17"])
def test_adam7_small_and_odd_shapes(shape):
    """Images smaller than Adam7's 8x8 tile leave some passes empty."""
    for color, depth, trns in ((0, 1, False), (3, 4, True), (6, 16, False)):
        data = case_png(color, depth, trns, True, shape=shape)
        np.testing.assert_array_equal(png.decode_png(data),
                                      png.decode_png_python(data))
        np.testing.assert_array_equal(png.decode_png_rgb(data),
                                      pil_rgb(data))


@pytest.mark.parametrize("case", [(3, 8, True), (0, 16, False),
                                  (2, 16, False), (4, 16, False),
                                  (0, 2, False)], ids=case_id)
def test_read_image_chw_and_kitti_view_equal_jax(tmp_path, case):
    """``read_image_chw`` and the camera's padded decode give the JAX
    package's image: for these files its ``read_image_chw`` is PIL's
    ``convert("RGB")`` as float32 CHW (``stereo_tpu/utils/image_io.py``;
    called through PIL here, so the JAX package's unlocked native build
    is not started beside other test processes)."""
    path = str(tmp_path / "image.png")
    with open(path, "wb") as f:
        f.write(case_png(*case, interlace=True))
    want = np.ascontiguousarray(
        pil_rgb(open(path, "rb").read()).transpose(2, 0, 1), np.float32)
    got = image_io.read_image_chw(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    padded = _native.decode_png_padded_chw(path, pad=KITTI_PAD)
    left, top, right, bottom = KITTI_PAD
    np.testing.assert_array_equal(
        padded, np.pad(want, ((0, 0), (top, bottom), (left, right))))


@pytest.mark.parametrize("case", [(0, 16, False), (3, 8, False),
                                  (2, 8, False), (6, 16, False)],
                         ids=case_id)
def test_upload_decode_equals_pil(case):
    """The server's upload decode at the pipeline shape: PIL's RGB."""
    data = case_png(*case, interlace=True, shape=(12, 20))
    got = decode_png_to_pipeline_image(data, (12, 20), "cpu")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy().transpose(1, 2, 0),
                                  pil_rgb(data))


def test_jpeg_is_refused_by_name():
    with pytest.raises(BadRequestError, match="JPEG"):
        png.decode_png(b"\xff\xd8\xff\xe0" + bytes(16))


@pytest.mark.parametrize("trns", [None, np.array([5, 6])],
                         ids=["opaque", "trns"])
def test_index_past_the_palette_reads_black(trns):
    """PIL reads an index past the palette as black (its own writer makes
    such files: a "P" image without a palette)."""
    index = np.array([[[0], [1], [2], [3]]])
    data = make_png(index, 2, 3, palette=np.array([[10, 20, 30],
                                                   [40, 50, 60]]),
                    trns=trns)
    samples = png.decode_png(data)
    np.testing.assert_array_equal(samples, png.decode_png_python(data))
    np.testing.assert_array_equal(png.decode_png_rgb(data), pil_rgb(data))
    if trns is not None:
        np.testing.assert_array_equal(samples[0, :, 3], [5, 6, 255, 255])


@pytest.mark.parametrize("make", [
    lambda: make_png(np.zeros((2, 2, 1)), 4, 3),
    lambda: make_png(np.zeros((2, 2, 3)), 4, 2),
    lambda: make_png(np.zeros((2, 2, 1)), 16, 3,
                     palette=np.zeros((4, 3))),
], ids=["no_palette", "rgb_4bit", "palette_16bit"])
def test_malformed_palette_and_depth_are_bad_requests(make):
    data = make()
    for decode in (png.decode_png, png.decode_png_python):
        with pytest.raises(BadRequestError):
            decode(data)
