"""The port's PNG codec: the server's uploads and the cameras share its
decoder, the hooks its encoder.

``decode_png`` checks the chunks (CRCs, header) here and decodes the
pixels with the native host runtime (``stereo_tpu_torch._native``, zlib
in C++): grey at 1, 2, 4, 8 and 16 bits, palette with or without
``tRNS``, grey+alpha, RGB and RGBA at 8 and 16 bits, plain or Adam7
interlaced, all five filter types (16-bit grey is KITTI's disparity
format); anything else raises ``BadRequestError``.  ``decode_png_rgb``
maps the samples to 8-bit RGB as an image library's RGB conversion does
(PIL's ``convert("RGB")``, which the JAX package uses);
``decode_png_image`` gives PIL's own mode and samples (a palette's
indices), which the stereo trainer's ground truth reads.
``decode_png_python`` is the same decode in Python, the rows unfiltered
byte by byte for the Average and Paeth filters: the native decoder's test
oracle.  ``encode_png`` writes 8-bit grey and RGB with the standard
library (``zlib``, ``struct``).  The card's machine has no imaging library.
JPEG bytes are refused here by name: ``utils.image_io.decode_image_rgb``
takes either format by its signature.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8\xff"
# PNG colour type -> (samples per stored pixel, bit depths it may have).
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
                3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7's seven passes: (first column, first row, column step, row step).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


class BadRequestError(ValueError):
    """Client-side input error (bad image payload, missing upload field):
    HTTP 400.  Anything else raised while serving is a server fault (500)."""


class _Png(NamedTuple):
    height: int
    width: int
    depth: int             # bits per stored sample
    color: int             # PNG colour type
    interlace: int         # 0 or 1 (Adam7)
    palette: bytes         # PLTE
    trns: bytes            # tRNS of a palette image, else b""
    idat: list

    @property
    def channels(self) -> int:
        """Samples per decoded pixel: a palette expands to RGB (RGBA with
        tRNS)."""
        if self.color == 3:
            return 4 if self.trns else 3
        return _COLOR_TYPES[self.color][0]


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise BadRequestError("truncated PNG chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(ctype + body):
            raise BadRequestError(f"PNG chunk {ctype!r} fails its CRC")
        yield ctype, body
        pos += 12 + length


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        start = y * (stride + 1)
        ftype = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prior
        elif ftype in (3, 4):
            out = bytearray(stride)
            up = prior.tobytes()
            for i, v in enumerate(line.tobytes()):
                left = out[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                out[i] = (v + pred) & 0xFF
            cur = np.frombuffer(bytes(out), np.uint8)
        else:
            raise BadRequestError(f"unknown PNG filter type {ftype}")
        rows[y] = cur
        prior = cur
    return rows


def _parse(data: bytes) -> _Png:
    """Check the signature, chunks and header of PNG bytes."""
    if not data.startswith(_SIGNATURE):
        if data.startswith(_JPEG_SIGNATURE):
            raise BadRequestError(
                "JPEG data is not a PNG (utils.image_io.decode_image_rgb "
                "decodes both)")
        raise BadRequestError("not a PNG file")
    header, idat, palette, trns = None, [], b"", b""
    try:
        for ctype, body in _chunks(data):
            if ctype == b"IHDR":
                header = struct.unpack(">IIBBBBB", body)
            elif ctype == b"PLTE":
                palette = body
            elif ctype == b"tRNS":
                trns = body
            elif ctype == b"IDAT":
                idat.append(body)
            elif ctype == b"IEND":
                break
    except struct.error as exc:
        raise BadRequestError(f"malformed PNG: {exc}") from exc
    if header is None:
        raise BadRequestError("PNG has no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if (color not in _COLOR_TYPES or depth not in _COLOR_TYPES[color][1]
            or interlace > 1 or width == 0 or height == 0):
        raise BadRequestError(
            f"unsupported PNG (bit depth {depth}, colour type {color}, "
            f"interlace {interlace})")
    if color == 3 and (not palette or len(palette) % 3 or len(palette) > 768):
        raise BadRequestError("palette PNG without a valid PLTE chunk")
    return _Png(height, width, depth, color, interlace, palette,
                trns if color == 3 else b"", idat)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) samples, decoded by the native host runtime:
    C = 1 (grey), 2 (grey+alpha), 3 (RGB, or a palette) or 4 (RGBA, or a
    palette with tRNS); uint16 for bit depth 16, else uint8 (grey below 8
    bits scaled to 0..255)."""
    from .. import _native

    png = _parse(data)
    try:
        return _native.decode_png_hwc(data).reshape(png.height, png.width,
                                                    png.channels)
    except ValueError as exc:   # inflate, size or filter-type failure
        raise BadRequestError(f"corrupt PNG data ({exc})") from exc


def decode_png_image(data: bytes):
    """PNG bytes -> (PIL's mode, its (H, W, C) samples, the palette's (N, 3)
    uint8 RGB of mode "P"), as PIL's ``Image.open`` holds them: grey as "1"
    (0 or 255), "L" (below 8 bits scaled to 0..255) or "I;16"; "LA", "RGB"
    and "RGBA" (16-bit samples by their high byte; 16-bit grey+alpha as
    "RGBA"); a palette as "P", its indices (``tRNS`` left aside, as PIL
    leaves it out of the samples)."""
    png = _parse(data)
    palette = np.frombuffer(png.palette, np.uint8).reshape(-1, 3)
    if png.color == 3:
        # The indices: the same file through the palette i -> (i, i, i).
        ramp = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
        indexed = bytearray(_SIGNATURE)
        for ctype, body in _chunks(data):
            if ctype != b"tRNS":
                indexed += _chunk(ctype, ramp if ctype == b"PLTE" else body)
            if ctype == b"IEND":
                break
        return "P", decode_png(bytes(indexed))[..., :1], palette
    samples = decode_png(data)
    if png.color == 0:
        return {1: "1", 16: "I;16"}.get(png.depth, "L"), samples, palette[:0]
    if png.depth == 16:
        samples = (samples >> 8).astype(np.uint8)
        if png.color == 4:  # PIL opens 16-bit grey+alpha as RGBA
            return "RGBA", samples[..., [0, 0, 0, 1]], palette[:0]
    return {2: "RGB", 4: "LA", 6: "RGBA"}[png.color], samples, palette[:0]


def rgb_like_pil(samples: np.ndarray) -> np.ndarray:
    """(H, W, C) samples of ``decode_png`` -> (H, W, 3) uint8, as PIL's
    ``convert("RGB")`` maps them: grey replicated, alpha dropped, 16-bit
    samples taken by their high byte but 16-bit grey clipped to 255."""
    channels = samples.shape[2]
    if samples.dtype == np.uint16:
        samples = np.minimum(samples, 255) if channels == 1 else samples >> 8
    rgb = samples[..., :3] if channels >= 3 else np.repeat(
        samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(rgb, dtype=np.uint8)


def decode_png_rgb(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB, as PIL's ``convert("RGB")`` gives
    it (``rgb_like_pil``)."""
    return rgb_like_pil(decode_png(data))


def _unpack(rows: np.ndarray, width: int, samples: int,
            depth: int) -> np.ndarray:
    """Unfiltered rows -> (rows, width * samples) sample values."""
    n = width * samples
    if depth == 16:
        return rows.view(">u2")[:, :n].astype(np.uint16)
    if depth == 8:
        return rows[:, :n]
    bits = np.unpackbits(rows, axis=1)[:, :n * depth]
    weights = 1 << np.arange(depth - 1, -1, -1)
    return (bits.reshape(len(rows), n, depth) * weights).sum(-1).astype(
        np.uint8)


def decode_png_python(data: bytes) -> np.ndarray:
    """``decode_png`` with zlib, the row filters, Adam7 and the palette in
    Python: the test oracle of the native decoder."""
    png = _parse(data)
    samples, depth = _COLOR_TYPES[png.color][0], png.depth
    bits = samples * depth                       # bits per stored pixel
    bpp = max(1, bits // 8)                      # the filters' byte distance
    try:
        raw = zlib.decompress(b"".join(png.idat))
    except zlib.error as exc:
        raise BadRequestError(f"corrupt PNG data: {exc}") from exc
    image = np.zeros((png.height, png.width, samples),
                     np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7 if png.interlace else ((0, 0, 1, 1),):
        pw = len(range(x0, png.width, dx))
        ph = len(range(y0, png.height, dy))
        if not pw or not ph:
            continue
        stride = (pw * bits + 7) // 8
        size = ph * (stride + 1)
        if pos + size > len(raw):
            raise BadRequestError("PNG data does not match its size")
        rows = _unfilter(raw[pos:pos + size], ph, stride, bpp)
        pos += size
        image[y0::dy, x0::dx] = _unpack(rows, pw, samples, depth).reshape(
            ph, pw, samples)
    if pos != len(raw):
        raise BadRequestError("PNG data does not match its size")
    if png.color == 3:
        # An index past the palette reads as black (as image libraries
        # read it), opaque unless tRNS says otherwise.
        palette = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(png.palette, np.uint8).reshape(-1, 3)
        palette[:len(entries)] = entries
        index = image[..., 0]
        if not png.trns:
            return palette[index]
        alpha = np.full(256, 255, np.uint8)
        trns = np.frombuffer(png.trns, np.uint8)[:256]
        alpha[:len(trns)] = trns
        return np.concatenate([palette[index], alpha[index][..., None]],
                              axis=2)
    if depth < 8:
        return image * np.uint8(255 // (2 ** depth - 1))
    return image


def encode_png(image: np.ndarray) -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 -> PNG bytes (filter type 0)."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim == 2:
        color = 0
    elif image.ndim == 3 and image.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"can only encode (H, W) or (H, W, 3), got "
                         f"{image.shape}")
    height, width = image.shape[:2]
    rows = image.reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)

    ihdr = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
