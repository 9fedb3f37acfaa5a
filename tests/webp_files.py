"""WebP files for the tests of the port's WebP decoder, built with NumPy and
the standard library where PIL's ``save`` cannot choose the variant:

* ``encode``: libwebp's encoder (the system's ``libwebp.so.7``, through
  ctypes) with the options Pillow does not pass on: token partitions, the
  simple loop filter, its sharpness, the number of segments, raw alpha,
  the alpha filter.  Only ``tests/fixtures/make_webp_fixtures.py`` calls
  it; the committed files are what the tests and the card read.
* ``riff``, ``chunks``: a RIFF container from chunks, and back.
* ``with_alph``: a lossy frame with an ALPH chunk built by hand: raw or
  VP8L-compressed, each of the three filters.
* ``animation``: frames in ANMF chunks at their offsets on a canvas.
* ``vp8_header``: the fields of a VP8 frame header that the fixtures are
  chosen for (segments, filter type, level and sharpness, partitions).
* ``damaged``: truncations, replaced bytes, rewritten RIFF and chunk sizes
  and rewritten VP8/VP8L header fields, for the agreement with PIL.
"""

import ctypes
import ctypes.util
import struct

import numpy as np


def chunk(tag: bytes, payload: bytes) -> bytes:
    """One RIFF chunk: tag, little-endian size, payload, padding byte."""
    return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (
        len(payload) & 1)


def riff(*chunks_: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks_)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def chunks(data: bytes) -> list:
    """The top-level (tag, payload) chunks of a WebP file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def vp8x(width: int, height: int, alpha: bool = False,
         animation: bool = False, flags: int = 0) -> bytes:
    flags |= (0x10 if alpha else 0) | (0x02 if animation else 0)
    return chunk(b"VP8X", struct.pack("<I", flags) + (width - 1).to_bytes(
        3, "little") + (height - 1).to_bytes(3, "little"))


def image_chunk(data: bytes) -> bytes:
    """The VP8 or VP8L chunk of a simple WebP file."""
    for tag, payload in chunks(data):
        if tag in (b"VP8 ", b"VP8L"):
            return chunk(tag, payload)
    raise ValueError("no VP8 or VP8L chunk")


def alpha_filter(alpha: np.ndarray, method: int) -> np.ndarray:
    """The ALPH chunk's forward filter (1 horizontal, 2 vertical, 3
    gradient), the inverse of libwebp's unfilters: the first row is
    filtered horizontally (its first pixel left as it is), the first pixel
    of a later row from the pixel above."""
    a = alpha.astype(np.int32)
    if method == 0:
        return alpha.copy()
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if method == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif method == 2:
        pred[1:, 1:] = a[:-1, 1:]
    else:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 0xff).astype(np.uint8)


def with_alph(lossy: bytes, alpha: np.ndarray, compression: int,
              method: int, lossless_green=None) -> bytes:
    """A VP8X file of the VP8 frame of ``lossy`` and an ALPH chunk made by
    hand: compression 0 (raw) or 1 (the VP8L stream ``lossless_green``
    gives for the filtered plane, without its 5-byte header), filter
    ``method``."""
    h, w = alpha.shape
    filtered = alpha_filter(alpha, method)
    if compression == 0:
        body = filtered.tobytes()
    else:
        green = np.zeros((h, w, 3), np.uint8)
        green[..., 1] = filtered
        vp8l = dict(chunks(lossless_green(green)))[b"VP8L"]
        body = vp8l[5:]
    alph = chunk(b"ALPH", bytes([compression | (method << 2)]) + body)
    return riff(vp8x(w, h, alpha=True), alph, image_chunk(lossy))


def animation(width: int, height: int, frames, background=(0, 0, 0, 0),
              loops: int = 0, alpha: bool = True) -> bytes:
    """An animated file: ``frames`` is (x, y, simple WebP file) with even
    offsets; each frame's image (and ALPH) chunks go into an ANMF chunk."""
    anim = chunk(b"ANIM", bytes(background[2::-1]) + bytes([background[3]])
                 + struct.pack("<H", loops))
    body = []
    for x, y, data in frames:
        inner = b"".join(chunk(t, p) for t, p in chunks(data)
                         if t in (b"ALPH", b"VP8 ", b"VP8L"))
        info = dict(chunks(data))
        if b"VP8X" in info:
            fw = 1 + int.from_bytes(info[b"VP8X"][4:7], "little")
            fh = 1 + int.from_bytes(info[b"VP8X"][7:10], "little")
        elif b"VP8L" in info:
            bits = int.from_bytes(info[b"VP8L"][1:5], "little")
            fw, fh = (bits & 0x3fff) + 1, ((bits >> 14) & 0x3fff) + 1
        else:
            fw = int.from_bytes(info[b"VP8 "][6:8], "little") & 0x3fff
            fh = int.from_bytes(info[b"VP8 "][8:10], "little") & 0x3fff
        head = b"".join(v.to_bytes(3, "little") for v in (
            x // 2, y // 2, fw - 1, fh - 1, 100)) + b"\0"
        body.append(chunk(b"ANMF", head + inner))
    return riff(vp8x(width, height, alpha=alpha, animation=True), anim, *body)


class _BoolReader:
    """RFC 6386's boolean decoder, enough to read a frame header."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.count = data, 2, 0
        self.value = int.from_bytes(data[:2], "big")
        self.range = 255

    def bit(self, prob: int = 128) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.value >= split << 8:
            bit, self.range, self.value = 1, self.range - split, \
                self.value - (split << 8)
        else:
            bit, self.range = 0, split
        while self.range < 128:
            self.value, self.range, self.count = (self.value << 1,
                                                  self.range << 1,
                                                  self.count + 1)
            if self.count == 8:
                self.count = 0
                if self.pos < len(self.data):
                    self.value |= self.data[self.pos]
                self.pos += 1
        return bit

    def value_of(self, n: int) -> int:
        return sum(self.bit() << i for i in reversed(range(n)))

    def signed(self, n: int) -> int:
        v = self.value_of(n)
        return -v if self.bit() else v


def vp8_header(data: bytes) -> dict:
    """Segments on or off, simple filter, level, sharpness and the number of
    token partitions of a file's VP8 frame."""
    vp8 = dict(chunks(data))[b"VP8 "]
    if b"ANMF" in dict(chunks(data)):
        raise ValueError("an animation")
    length = int.from_bytes(vp8[:3], "little") >> 5
    br = _BoolReader(vp8[10:10 + length])
    br.bit(), br.bit()   # colour space, clamping
    segments = br.bit()
    if segments:
        update_map = br.bit()
        if br.bit():
            br.bit()
            for bits in (7,) * 4 + (6,) * 4:
                if br.bit():
                    br.signed(bits)
        if update_map:
            for _ in range(3):
                if br.bit():
                    br.value_of(8)
    simple, level, sharpness = br.bit(), br.value_of(6), br.value_of(3)
    if br.bit() and br.bit():
        for _ in range(8):
            if br.bit():
                br.signed(6)
    return {"segments": segments, "simple": simple, "level": level,
            "sharpness": sharpness, "partitions": 1 << br.value_of(2)}


# --- libwebp's encoder, for the options PIL's save does not pass on ---------

class _Config(ctypes.Structure):
    _fields_ = [(n, t) for n, t in (
        ("lossless", ctypes.c_int), ("quality", ctypes.c_float),
        ("method", ctypes.c_int), ("image_hint", ctypes.c_int),
        ("target_size", ctypes.c_int), ("target_PSNR", ctypes.c_float),
        ("segments", ctypes.c_int), ("sns_strength", ctypes.c_int),
        ("filter_strength", ctypes.c_int), ("filter_sharpness", ctypes.c_int),
        ("filter_type", ctypes.c_int), ("autofilter", ctypes.c_int),
        ("alpha_compression", ctypes.c_int), ("alpha_filtering", ctypes.c_int),
        ("alpha_quality", ctypes.c_int), ("pass", ctypes.c_int),
        ("show_compressed", ctypes.c_int), ("preprocessing", ctypes.c_int),
        ("partitions", ctypes.c_int), ("partition_limit", ctypes.c_int),
        ("emulate_jpeg_size", ctypes.c_int), ("thread_level", ctypes.c_int),
        ("low_memory", ctypes.c_int), ("near_lossless", ctypes.c_int),
        ("exact", ctypes.c_int), ("use_delta_palette", ctypes.c_int),
        ("use_sharp_yuv", ctypes.c_int), ("qmin", ctypes.c_int),
        ("qmax", ctypes.c_int))]


_P = ctypes.c_void_p


class _Picture(ctypes.Structure):
    _fields_ = [
        ("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("y", _P), ("u", _P), ("v", _P),
        ("y_stride", ctypes.c_int), ("uv_stride", ctypes.c_int),
        ("a", _P), ("a_stride", ctypes.c_int),
        ("pad1", ctypes.c_uint32 * 2),
        ("argb", _P), ("argb_stride", ctypes.c_int),
        ("pad2", ctypes.c_uint32 * 3),
        ("writer", _P), ("custom_ptr", _P),
        ("extra_info_type", ctypes.c_int), ("extra_info", _P),
        ("stats", _P), ("error_code", ctypes.c_int),
        ("progress_hook", _P), ("user_data", _P),
        ("pad3", ctypes.c_uint32 * 3), ("pad4", _P), ("pad5", _P),
        ("pad6", ctypes.c_uint32 * 8), ("memory_", _P),
        ("memory_argb_", _P), ("pad7", _P * 2)]


class _MemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)),
                ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                ("pad", ctypes.c_uint32 * 1)]


_ENCODER_ABI = 0x020f   # WEBP_ENCODER_ABI_VERSION of encode.h


def encode(pixels: np.ndarray, **options) -> bytes:
    """RGB or RGBA uint8 (H, W, C) -> WebP bytes from libwebp's
    ``WebPEncode`` with ``options`` set on its ``WebPConfig`` (after
    ``WebPConfigInit`` at ``quality``, default 75).  libwebp writes more
    than one token partition only at ``method`` 2 or below."""
    lib = ctypes.CDLL(ctypes.util.find_library("webp") or "libwebp.so.7")
    config = _Config()
    if not lib.WebPConfigInitInternal(ctypes.byref(config), 0, ctypes.c_float(
            options.pop("quality", 75.0)), _ENCODER_ABI):
        raise RuntimeError("WebPConfigInit failed")
    for key, value in options.items():
        setattr(config, key, value)
    if not lib.WebPValidateConfig(ctypes.byref(config)):
        raise ValueError(f"invalid WebP options {options}")
    pic = _Picture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), _ENCODER_ABI):
        raise RuntimeError("WebPPictureInit failed")
    h, w, c = pixels.shape
    pic.width, pic.height = w, h
    pic.use_argb = int(config.lossless)
    px = np.ascontiguousarray(pixels, np.uint8)
    importer = (lib.WebPPictureImportRGBA if c == 4
                else lib.WebPPictureImportRGB)
    writer = _MemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    try:
        if not importer(ctypes.byref(pic), px.ctypes.data_as(_P), w * c):
            raise RuntimeError("WebPPictureImport failed")
        pic.writer = ctypes.cast(lib.WebPMemoryWrite, _P)
        pic.custom_ptr = ctypes.cast(ctypes.pointer(writer), _P)
        if not lib.WebPEncode(ctypes.byref(config), ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode failed ({pic.error_code})")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


# --- damage ------------------------------------------------------------------

DAMAGE = ("truncate", "flip", "riff_size", "chunk_size", "header",
          "cut_payload")


def _size_value(rng: np.random.Generator, old: int) -> int:
    """A size near the old one, or at an edge of 32 bits."""
    choices = [old + int(rng.integers(-9, 10)), 0, 1, 7, 8, 9, 10,
               0x7fffffff, 0xfffffff6, 0xfffffff7, 0xffffffff,
               int(rng.integers(0, 1 << 32))]
    return choices[int(rng.integers(len(choices)))] & 0xffffffff


def damaged(data: bytes, rng: np.random.Generator, kind: str) -> bytes:
    """``data`` cut at a seeded length ("truncate"), with 1-4 seeded bytes
    replaced ("flip"), its RIFF size rewritten ("riff_size"), one chunk's
    size rewritten ("chunk_size", nested ANMF chunks included), 1-3 bytes
    of a VP8 frame header or a VP8L header replaced ("header"), or the last
    top-level chunk's payload cut at a seeded length with the chunk and
    RIFF sizes made to agree ("cut_payload": the container stays valid and
    the bitstream ends early)."""
    out = bytearray(data)
    if kind == "truncate":
        return data[:int(rng.integers(1, len(data)))]
    if kind == "cut_payload":
        parts = chunks(data)
        tag, payload = parts[-1]
        cut = payload[:int(rng.integers(0, len(payload) + 1))]
        return riff(*(chunk(t, p) for t, p in parts[:-1]), chunk(tag, cut))
    if kind == "flip":
        for _ in range(int(rng.integers(1, 5))):
            out[int(rng.integers(0, len(out)))] = int(rng.integers(0, 256))
        return bytes(out)
    if kind == "riff_size":
        out[4:8] = struct.pack("<I", _size_value(rng, len(data) - 8))
        return bytes(out)
    offsets, headers = [], []
    pos, end = 12, len(data)
    stack = []
    while pos + 8 <= end:
        tag = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        offsets.append((pos + 4, size))
        if tag == b"VP8 ":
            headers.append((pos + 8, 10))
        elif tag == b"VP8L":
            headers.append((pos + 8, 5))
        if tag == b"ANMF":
            stack.append(pos + 8 + size + (size & 1))
            pos += 8 + 16
            continue
        pos += 8 + size + (size & 1)
        while stack and pos >= stack[-1]:
            pos = stack.pop()
    if kind == "chunk_size" and offsets:
        at, size = offsets[int(rng.integers(len(offsets)))]
        out[at:at + 4] = struct.pack("<I", _size_value(rng, size))
        return bytes(out)
    if headers:
        start, length = headers[int(rng.integers(len(headers)))]
        for _ in range(int(rng.integers(1, 4))):
            at = start + int(rng.integers(0, length))
            if at < len(out):
                out[at] = int(rng.integers(0, 256))
        return bytes(out)
    return bytes(out)
