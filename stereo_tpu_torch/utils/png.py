"""The port's PNG codec: the server's uploads and the cameras share its
decoder, the hooks its encoder.

``decode_png`` checks the chunks (CRCs, header) here and decodes the
pixels with the native host runtime (``stereo_tpu_torch._native``, zlib
in C++): 8- and 16-bit grey, RGB and RGBA (16-bit grey is KITTI's
disparity format), non-interlaced, all five filter types; anything else
raises ``BadRequestError``.  ``decode_png_python`` is the same decode with
the rows unfiltered in Python, byte by byte for the Average and Paeth
filters: the native decoder's test oracle.
``encode_png`` writes 8-bit grey and RGB with the standard library
(``zlib``, ``struct``).  The card's machine has no imaging library.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}       # PNG colour type -> samples per pixel


class BadRequestError(ValueError):
    """Client-side input error (bad image payload, missing upload field):
    HTTP 400.  Anything else raised while serving is a server fault (500)."""


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


def _parse(data: bytes):
    """Check the signature, chunks and header of PNG bytes: returns
    ``(height, width, channels, bit_depth, idat_chunks)``."""
    if not data.startswith(_SIGNATURE):
        raise BadRequestError("not a PNG file")
    header, idat = None, []
    try:
        for ctype, body in _chunks(data):
            if ctype == b"IHDR":
                header = struct.unpack(">IIBBBBB", body)
            elif ctype == b"IDAT":
                idat.append(body)
            elif ctype == b"IEND":
                break
    except struct.error as exc:
        raise BadRequestError(f"malformed PNG: {exc}") from exc
    if header is None:
        raise BadRequestError("PNG has no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if depth not in (8, 16) or color not in _CHANNELS or interlace != 0:
        raise BadRequestError(
            f"unsupported PNG (bit depth {depth}, colour type {color}, "
            f"interlace {interlace}); 8- or 16-bit grey, RGB or RGBA only")
    return height, width, _CHANNELS[color], depth, idat


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) with C = 1, 3 or 4, uint8 for bit depth 8
    and uint16 for 16, decoded by the native host runtime."""
    from .. import _native

    height, width, channels, _, _ = _parse(data)
    try:
        return _native.decode_png_hwc(data).reshape(height, width, channels)
    except ValueError as exc:   # inflate, size or filter-type failure
        raise BadRequestError(f"corrupt PNG data ({exc})") from exc


def decode_png_python(data: bytes) -> np.ndarray:
    """``decode_png`` with zlib and the row filters in Python: the test
    oracle of the native decoder."""
    height, width, channels, depth, idat = _parse(data)
    bpp = channels * depth // 8          # the filters' byte distance
    stride = width * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise BadRequestError(f"corrupt PNG data: {exc}") from exc
    if len(raw) != height * (stride + 1):
        raise BadRequestError("PNG data does not match its size")
    rows = _unfilter(raw, height, stride, bpp)
    if depth == 16:
        rows = rows.view(">u2").astype(np.uint16)
    return rows.reshape(height, width, channels)


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

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))
