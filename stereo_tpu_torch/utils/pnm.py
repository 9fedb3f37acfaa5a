"""PNM (P1-P6) and PFM (``Pf``) files, decoded as PIL's ``PpmImagePlugin``
decodes them (NumPy only).  Pillow's own test-only headers (``P0CMYK``,
``PyP``, ``PyRGBA``, ``PyCMYK``) are refused as unknown magic numbers.

``decode_pnm`` returns PIL's mode and samples before any conversion:
P1/P4 are mode ``"1"``; P2/P5 ``"L"``, or ``"I"`` at a maxval over 255;
P3/P6 ``"RGB"``; ``Pf`` ``"F"``, its rows stored bottom-up and the sign of
its scale giving the byte order (negative: little-endian).  PIL scales a
maxval other than 255 to 8 bits (``round(v / maxval * 255)``, half to
even, clipped), or to 16 bits in mode ``"I"``, except a P5 at maxval 65535,
which it reads unscaled.  The ASCII variants are read token by token in
PIL's 1 MiB blocks.  Files PIL refuses (a bad header, a value over maxval,
too little data, colour ``PF``) raise ``ValueError``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_WHITESPACE = b" \t\n\x0b\x0c\r"
_BLOCK = 1024 * 1024           # PIL's ImageFile.SAFEBLOCK
_MAX_PIXELS = 2 * 89478485     # PIL's decompression-bomb limit, 2x
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
          b"P6": "RGB", b"Pf": "F"}
_BANDS = {"1": 1, "L": 1, "I": 1, "F": 1, "RGB": 3}


def is_pnm(data: bytes) -> bool:
    """PIL's test of the first bytes: ``P`` and one of ``0123456fy``."""
    return len(data) >= 2 and data[:1] == b"P" and data[1] in b"0123456fy"


class _Stream:
    """A file position over bytes in memory, read as PIL reads its file."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out


def _magic(s: _Stream) -> bytes:
    magic = b""
    for _ in range(6):
        c = s.read(1)
        if not c or c in _WHITESPACE:
            break
        magic += c
    return magic


def _token(s: _Stream) -> bytes:
    """A header token (PIL's ``_read_token``): whitespace and ``#``
    comments skipped, at most 10 characters."""
    token = b""
    while len(token) <= 10:
        c = s.read(1)
        if not c:
            break
        if c in _WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while s.read(1) not in b"\r\n":
                pass
            continue
        token += c
    if not token:
        raise ValueError("PNM: reached EOF while reading header")
    if len(token) > 10:
        raise ValueError("PNM: token too long in file header")
    return token


class _Plain:
    """PIL's ``PpmPlainDecoder``: the ASCII bodies, read in 1 MiB blocks
    with comments removed."""

    def __init__(self, s: _Stream):
        self.s, self.spans = s, False

    @staticmethod
    def _comment_end(block: bytes, start: int = 0) -> int:
        a, b = block.find(b"\n", start), block.find(b"\r", start)
        return min(a, b) if a * b > 0 else max(a, b)

    def _uncommented(self, block: bytes) -> bytes:
        if self.spans:
            while block:
                end = self._comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.s.read(_BLOCK)
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = self._comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block = block[:start]
                self.spans = True
                break
        return block

    def bitonal(self, total: int) -> bytes:
        data = bytearray()
        while len(data) != total:
            block = self.s.read(_BLOCK)
            if not block:
                break
            tokens = b"".join(self._uncommented(block).split())
            if tokens.translate(None, b"01"):
                raise ValueError("PNM: invalid token for a bitmap")
            data = (data + tokens)[:total]
        return bytes(data)

    def values(self, total: int, maxval: int, out_max: int) -> list:
        data = []
        half = b""
        while len(data) != total:
            block = self.s.read(_BLOCK)
            if not block:
                if not half:
                    break
                block = b" "
            block = self._uncommented(block)
            if half:
                block, half = half + block, b""
            tokens = block.split()
            if block and not block[-1:].isspace():
                half = tokens.pop()
                if len(half) > 10:
                    raise ValueError("PNM: token too long in data")
            for token in tokens:
                if len(token) > 10:
                    raise ValueError("PNM: token too long in data")
                value = int(token)
                if value < 0 or value > maxval:
                    raise ValueError(f"PNM: channel value {value} out of "
                                     f"0..{maxval}")
                data.append(round(value / maxval * out_max))
                if len(data) == total:
                    break
        return data


def decode_pnm(data: bytes) -> Tuple[str, np.ndarray]:
    """PNM/PFM bytes -> (PIL's mode, (H, W, bands) samples: uint8, or
    int32 in mode ``"I"``, float32 in mode ``"F"``); ``"1"`` is 0 or 255.
    Raises ``ValueError`` where PIL refuses the file."""
    if not is_pnm(data):
        raise ValueError("not a PNM file")
    s = _Stream(data)
    magic = _magic(s)
    if magic not in _MODES:
        raise ValueError(f"PNM: unknown magic number {magic!r}")
    mode = _MODES[magic]
    width, height = int(_token(s)), int(_token(s))
    plain = magic in (b"P1", b"P2", b"P3")
    scale = maxval = 0
    if mode == "F":
        scale = float(_token(s))
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("PFM: scale must be finite and non-zero")
    elif mode != "1":
        maxval = int(_token(s))
        if not 0 < maxval < 65536:
            raise ValueError("PNM: maxval must be in 1..65535")
        if maxval > 255 and mode == "L":
            mode = "I"
    if width <= 0 or height <= 0:
        raise ValueError(f"PNM: image size {width}x{height}")
    if width * height > _MAX_PIXELS:
        raise ValueError("PNM: image too large (over 178956970 pixels)")
    bands = _BANDS[mode]
    count = width * height * bands
    shape = (height, width, bands)
    body = data[s.pos:]
    if mode == "1":
        if plain:
            bits = _Plain(s).bitonal(width * height)
            if len(bits) < width * height:
                raise ValueError("PNM: not enough image data")
            samples = np.frombuffer(bits, np.uint8) == ord("0")
        else:
            row = (width + 7) // 8
            if len(body) < row * height:
                raise ValueError("PNM: image file is truncated")
            packed = np.frombuffer(body, np.uint8, row * height)
            samples = np.unpackbits(packed.reshape(height, row),
                                    axis=1)[:, :width] == 0
        return mode, np.where(samples, 255, 0).astype(np.uint8).reshape(shape)
    if mode == "F":
        if len(body) < 4 * count:
            raise ValueError("PFM: image file is truncated")
        floats = np.frombuffer(body, "<f4" if scale < 0 else ">f4", count)
        return mode, floats.astype(np.float32).reshape(shape)[::-1].copy()
    out_max = 65535 if mode == "I" else 255
    dtype = np.int32 if mode == "I" else np.uint8
    if plain:
        values = _Plain(s).values(count, maxval, out_max)
        if len(values) < count:
            raise ValueError("PNM: not enough image data")
        return mode, np.asarray(values, dtype).reshape(shape)
    wide = maxval > 255
    if len(body) < count * (2 if wide else 1):
        raise ValueError("PNM: image file is truncated")
    raw = np.frombuffer(body, ">u2" if wide else np.uint8, count)
    if maxval == 65535 and mode == "I" or maxval == 255:
        return mode, raw.astype(dtype).reshape(shape)
    scaled = np.minimum(out_max, np.round(raw / maxval * out_max))
    return mode, scaled.astype(dtype).reshape(shape)
