"""ctypes bindings of the port's native host runtime (``stereo_native.cc``,
``jpeg.cc``, ``mpeg4.cc`` and ``raster.cc``).

A copy of ``stereo_tpu/_native`` for the port: a zlib PNG decoder (every
colour type, bit depth and interlace, from bytes in memory or from a
file), a JPEG decoder (``jpeg_info``, ``decode_jpeg_rgb``: the bytes of
PIL's ``convert("RGB")`` on libjpeg-turbo's defaults), BMP, TIFF and GIF
decoders (``decode_raster``: PIL's mode and samples), an MPEG-4 Part 2
video encoder and decoder (``Mpeg4Encoder``, ``mp4v_config``,
``decode_mp4v``: the intra-only ``mp4v`` stream of the context video),
layout conversions
(HWC uint8 -> padded CHW float32, bilinear resize, mean pool, RGB ->
luma) and a threaded frame prefetcher, and a zstd decoder and zlib/gzip
inflation for Orbax checkpoints (``zstd_decompress``, ``inflate``).
Unlike the JAX package's copy it has no NumPy or imaging fallback: the
library is built from the four sources with one ``g++ ... -lz`` call on first
use into ``stereo_tpu_torch/_build/`` (named by a hash of the sources and
the flags, so a later process reuses it), and a failed build raises with
the compiler's log.  Importing this module builds nothing.
``available()`` and ``build_error()`` report the build's state (they
build on first call); with no fallback, nothing switches on them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Optional, Sequence, Tuple, Union

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "stereo_native.cc")
JPEG_SOURCE = os.path.join(_DIR, "jpeg.cc")
MPEG4_SOURCE = os.path.join(_DIR, "mpeg4.cc")
RASTER_SOURCE = os.path.join(_DIR, "raster.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_library = None
_build_error: Optional[str] = None   # why the last build or load failed
build_seconds = 0.0   # wall time of this process's g++ call, 0 on a cache hit

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIZE = ctypes.c_size_t
_I64 = ctypes.c_int64
_IP = ctypes.POINTER(ctypes.c_int)
_I64P = ctypes.POINTER(ctypes.c_int64)
_BUF = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
_SIGNATURES = {
    "sn_png_info_mem": ((_P, _SIZE, _IP, _IP, _IP, _IP), _I),
    "sn_decode_png_hwc_mem": ((_P, _SIZE, _P, _I, _I, _I, _I), _I),
    "sn_png_shape": ((ctypes.c_char_p, _IP, _IP, _IP), _I),
    "sn_decode_png_chw": ((ctypes.c_char_p, _I, _I, _I, _I, _F, _P, _I, _I),
                          _I),
    "sn_hwc_to_padded_chw": ((_P, _I, _I, _I, _I, _I, _I, _I, _F, _P), None),
    "sn_resize_bilinear_chw": ((_P, _I, _I, _I, _P, _I, _I), None),
    "sn_mean_pool": ((_P, _I, _I, _I, _P), None),
    "sn_rgb_to_gray": ((_P, _I, _I, _P), None),
    "sn_prefetcher_create": ((_I, _I, _I, _I, _I, _I, _I, _F, _I), _P),
    "sn_prefetcher_submit": ((_P, ctypes.c_char_p), ctypes.c_int64),
    "sn_prefetcher_next": ((_P, _P), _I),
    "sn_prefetcher_destroy": ((_P,), None),
    "sn_zstd_decompress": ((_P, _SIZE, _BUF), ctypes.c_int64),
    "sn_inflate": ((_P, _SIZE, _BUF), ctypes.c_int64),
    "sn_free": ((_P,), None),
    "sn_jpeg_info_mem": ((_P, _SIZE, _IP, _IP, _IP), _I),
    "sn_decode_jpeg_mem": ((_P, _SIZE, _P, _I, _I, _I), _I),
    "sn_mp4v_config": ((_I, _I, _I, _P, _I), _I),
    "sn_mp4v_encoder_create": ((_I, _I, _I, _I, _I, _IP), _P),
    "sn_mp4v_encoder_encode": ((_P, _P, _I64, _I64, _I64, _I64), _I64),
    "sn_mp4v_encoder_output": ((_P,), _P),
    "sn_mp4v_encoder_destroy": ((_P,), None),
    "sn_mp4v_vol_info": ((_P, _SIZE, _IP, _IP, _IP), _I),
    "sn_mp4v_decode": ((_P, _SIZE, _P, _SIZE, _P, _I), _I),
    "sn_mp4v_idct": ((_P, _P, _I, _I, _I), None),
    "sn_raster_decode": ((_P, _SIZE, _I64P, _BUF), _I),
}

_ZSTD_ERRORS = {-1: "truncated input", -2: "corrupt data",
                -3: "the frame names a dictionary, which is not supported",
                -4: "content checksum mismatch",
                -5: "not a zstd or skippable frame",
                -6: "content size differs from the frame header's",
                -7: "out of memory"}

# jpeg.cc's error codes (JpegCode).
_JPEG_ERRORS = {
    -1: "image file is truncated",
    -2: "corrupt or malformed JPEG data",
    -3: "not a JPEG file (it does not start with FF D8 FF)",
    -4: "arithmetic coding (SOF9-11) is not supported",
    -5: "lossless JPEG (SOF3) is not supported",
    -6: "hierarchical JPEG (SOF5-7, SOF13-15) is not supported",
    -7: "only 8-bit sample precision is supported",
    -8: "only 1, 3 or 4 components are supported",
    -9: "unsupported sampling factors",
    -10: "image too large (a side over 65500, or over 178956970 pixels)",
    -11: "out of memory",
    -12: "no image (EOI before any scan)"}

# mpeg4.cc's error codes (Mp4vCode).
_MP4V_ERRORS = {
    -1: "the stream is truncated",
    -2: "corrupt data (an invalid code or a missing marker bit)",
    -3: "no video object layer header",
    -4: "only rectangular video objects are supported",
    -5: "interlaced video is not supported",
    -6: "a coding tool beyond the Simple Profile's intra coding (sprites, "
        "OBMC, resync markers, data partitioning, scalability, complexity "
        "estimation, chroma other than 4:2:0, other object types)",
    -7: "MPEG quantisation (quant_type 1) is not supported",
    -8: "only I-VOPs are supported (a P-, B- or S-VOP)",
    -9: "a not-coded VOP",
    -10: "a frame of another size than the stream's",
    -11: "dquant, AC prediction or an intra_dc_vlc_thr other than 0",
    -12: "out of memory, or no thread could start",
    -13: "unsupported arguments (an odd or zero size, fps or quantiser out "
         "of range)",
    -14: "no VOP in the sample"}


# raster.cc's error codes (RasterCode).
_RASTER_ERRORS = {
    -1: "image file is truncated",
    -2: "corrupt or malformed image data",
    -3: "not a BMP, TIFF or GIF file (by its signature)",
    -4: "image too large (over 178956970 pixels)",
    -5: "out of memory",
    -6: "a header, depth, compression or bitfields layout PIL refuses",
    -7: "a layout PIL refuses (photometric, sample format, bits, extra "
        "samples, tags or data organization)",
    -10: "JPEG compression is not supported",
    -11: "CCITT compression is not supported",
    -12: "LZMA compression is not supported",
    -13: "ZSTD compression is not supported",
    -14: "WebP compression is not supported",
    -15: "ThunderScan, SGILog or 16-bit-padded compression is not supported",
    -16: "YCbCr (photometric 6) is not supported",
    -17: "CIELab (photometric 8) is not supported"}

# raster.cc's modes (Mode), by PIL's names, with the dtype of their samples.
RASTER_MODES = (("1", np.uint8), ("L", np.uint8), ("P", np.uint8),
                ("LA", np.uint8), ("PA", np.uint8), ("RGB", np.uint8),
                ("RGBA", np.uint8), ("CMYK", np.uint8), ("I;16", np.uint16),
                ("I", np.int32), ("F", np.float32))
_RASTER_FORMATS = {1: "BMP", 2: "TIFF", 3: "GIF"}


def _sources():
    """The library's C++ sources, compiled together by one g++ call."""
    return SOURCE, JPEG_SOURCE, MPEG4_SOURCE, RASTER_SOURCE


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for source in _sources():
        with open(source, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libstereo_native_{digest.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """One g++ call into a temporary name, then an atomic rename, so that
    processes building at once never load a half-written library."""
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *GXX_FLAGS, *_sources(), "-o", tmp, "-lz"]
    start = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"native build failed: {' '.join(cmd)}: {exc}") \
            from exc
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    build_seconds = time.perf_counter() - start


def library() -> ctypes.CDLL:
    """The loaded native library (built on first use)."""
    global _library, _build_error
    with _lock:
        if _library is None:
            path = library_path()
            try:
                if not os.path.isfile(path):
                    _build(path)
                lib = ctypes.CDLL(path)
            except (RuntimeError, OSError) as exc:
                _build_error = str(exc)
                raise
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _library = lib
    return _library


def available() -> bool:
    """True when the native library builds (on first call) and loads."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def build_error() -> Optional[str]:
    """The build's or the load's error message, or None when the library
    loads."""
    return None if available() else _build_error


def _ptr(arr: np.ndarray) -> int:
    return arr.ctypes.data


def _f32(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr, np.float32)


def png_info(data: bytes):
    """(H, W, C, bit depth) of PNG bytes from their header, or the
    decoder's error code (a negative int) for one it does not take."""
    h, w, c, d = (ctypes.c_int() for _ in range(4))
    rc = library().sn_png_info_mem(data, len(data), ctypes.byref(h),
                                   ctypes.byref(w), ctypes.byref(c),
                                   ctypes.byref(d))
    return rc if rc else (h.value, w.value, c.value, d.value)


def decode_png_hwc(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C), C = 1 (grey), 2 (grey + alpha), 3 (RGB or
    a palette) or 4 (RGBA or a palette with tRNS): uint16 for bit depth
    16, else uint8 (grey below 8 bits scaled to 0..255); raises
    ``ValueError`` with the decoder's code for bytes it does not take."""
    info = png_info(data)
    if isinstance(info, int):
        raise ValueError(f"native PNG decoder: error {info}")
    *shape, depth = info
    out = np.empty(shape, np.uint16 if depth == 16 else np.uint8)
    rc = library().sn_decode_png_hwc_mem(data, len(data), _ptr(out), *info)
    if rc:
        raise ValueError(f"native PNG decoder: error {rc}")
    return out


def png_shape(path: str):
    """(H, W, C) of a PNG file, or None for one the decoder does not
    take."""
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if library().sn_png_shape(os.fsencode(path), ctypes.byref(h),
                              ctypes.byref(w), ctypes.byref(c)):
        return None
    return h.value, w.value, c.value


def decode_png_padded_chw(path: str, pad: Sequence[int] = (0, 0, 0, 0),
                          scale: float = 1.0) -> np.ndarray:
    """PNG file -> (3, top+H+bottom, left+W+right) float32 RGB times
    ``scale``, the values of PIL's ``convert("RGB")`` (grey replicated,
    alpha dropped, 16-bit samples by their high byte but 16-bit grey
    clipped to 255); ``pad`` is (left, top, right, bottom).  Raises
    ``ValueError`` for a file the decoder does not take."""
    shape = png_shape(path)
    if shape is None:
        raise ValueError(f"native PNG decoder cannot read {path!r}")
    h, w, _ = shape
    left, top, right, bottom = pad
    out = np.empty((3, top + h + bottom, left + w + right), np.float32)
    rc = library().sn_decode_png_chw(os.fsencode(path), left, top, right,
                                     bottom, scale, _ptr(out), out.shape[1],
                                     out.shape[2])
    if rc:
        raise ValueError(f"native PNG decoder: error {rc} for {path!r}")
    return out


def hwc_to_padded_chw(hwc_u8: np.ndarray, pad: Sequence[int] = (0, 0, 0, 0),
                      scale: float = 1.0) -> np.ndarray:
    """uint8 (H, W, C) -> padded float32 (3, H', W') times ``scale``."""
    arr = np.ascontiguousarray(hwc_u8, np.uint8)
    if arr.ndim != 3:
        raise ValueError(f"expected (H, W, C) uint8, got {arr.shape}")
    h, w, c = arr.shape
    left, top, right, bottom = pad
    out = np.empty((3, top + h + bottom, left + w + right), np.float32)
    library().sn_hwc_to_padded_chw(_ptr(arr), h, w, c, left, top, right,
                                   bottom, scale, _ptr(out))
    return out


def resize_bilinear_chw(chw: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(C, H, W) float32 -> (C, out_h, out_w): the triangle filter with
    half-pixel centres, antialiased on downscale (``jax.image.resize``'s
    "bilinear")."""
    src = _f32(chw)
    c, h, w = src.shape
    out = np.empty((c, out_h, out_w), np.float32)
    library().sn_resize_bilinear_chw(_ptr(src), c, h, w, _ptr(out), out_h,
                                     out_w)
    return out


def mean_pool(hw: np.ndarray, k: int) -> np.ndarray:
    """(H, W) float32 -> k x k means, ceil-div output, edges replicated."""
    src = _f32(hw)
    h, w = src.shape
    out = np.empty((-(-h // k), -(-w // k)), np.float32)
    library().sn_mean_pool(_ptr(src), h, w, k, _ptr(out))
    return out


def rgb_to_gray(chw: np.ndarray) -> np.ndarray:
    """(3, H, W) float32 -> (H, W) ITU-R 601 luma, ``(R + G) + B``."""
    src = _f32(chw)
    _, h, w = src.shape
    out = np.empty((h, w), np.float32)
    library().sn_rgb_to_gray(_ptr(src), h, w, _ptr(out))
    return out


def _decoded(fn, data, what: str) -> bytes:
    """Runs a native decoder that hands back a malloc'd buffer; its bytes,
    or ``ValueError`` with the decoder's reason."""
    src = bytes(data)
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = fn(src, len(src), ctypes.byref(out))
    if n < 0:
        raise ValueError(f"{what}: {_ZSTD_ERRORS.get(n, f'error {n}')}")
    try:
        return ctypes.string_at(out, n)
    finally:
        library().sn_free(out)


def jpeg_info(data) -> Union[Tuple[int, int, int], int]:
    """(H, W, components) of JPEG bytes from the markers up to the first
    scan, or the decoder's error code (a negative int) for bytes it does
    not take."""
    src = bytes(data)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = library().sn_jpeg_info_mem(src, len(src), ctypes.byref(h),
                                    ctypes.byref(w), ctypes.byref(c))
    return rc if rc else (h.value, w.value, c.value)


def decode_jpeg_rgb(data) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, the values of PIL's
    ``Image.open(f).convert("RGB")`` on libjpeg-turbo (``jpeg.cc``).
    Raises ``ValueError`` naming the reason for bytes it does not take."""
    src = bytes(data)
    info = jpeg_info(src)
    if isinstance(info, int):
        raise ValueError(f"JPEG: {_JPEG_ERRORS.get(info, info)}")
    h, w, _ = info
    out = np.empty((h, w, 3), np.uint8)
    rc = library().sn_decode_jpeg_mem(src, len(src), _ptr(out), h, w, 0)
    if rc:
        raise ValueError(f"JPEG: {_JPEG_ERRORS.get(rc, rc)}")
    return out


def decode_jpeg(data) -> Tuple[str, np.ndarray]:
    """JPEG bytes -> (PIL's mode, its (H, W, C) uint8 samples), as PIL's
    ``Image.open`` holds them: "L" for one component, "RGB" for three,
    "CMYK" for four (libjpeg's CMYK inverted, PIL's "CMYK;I").  Raises
    ``decode_jpeg_rgb``'s ``ValueError``."""
    src = bytes(data)
    info = jpeg_info(src)
    if isinstance(info, int):
        raise ValueError(f"JPEG: {_JPEG_ERRORS.get(info, info)}")
    h, w, components = info
    if components != 4:
        rgb = decode_jpeg_rgb(src)
        return ("L", rgb[..., :1]) if components == 1 else ("RGB", rgb)
    out = np.empty((h, w, 4), np.uint8)
    rc = library().sn_decode_jpeg_mem(src, len(src), _ptr(out), h, w, 1)
    if rc:
        raise ValueError(f"JPEG: {_JPEG_ERRORS.get(rc, rc)}")
    return "CMYK", out


def decode_raster(data) -> Tuple[str, np.ndarray, np.ndarray, int, str]:
    """BMP, TIFF or GIF bytes -> (PIL's mode, its (H, W, C) samples, the
    palette's (N, 3) uint8 RGB of modes P and PA, TIFF's Orientation tag,
    the format's name), as PIL's ``Image.open`` decodes them before any
    conversion (``raster.cc``; the Orientation is not applied).  Raises
    ``ValueError`` naming the reason for bytes it does not take."""
    src = bytes(data)
    meta = (ctypes.c_int64 * 6)()
    out = ctypes.POINTER(ctypes.c_uint8)()
    rc = library().sn_raster_decode(src, len(src), meta, ctypes.byref(out))
    if rc:
        name = ("BMP" if src[:2] == b"BM" else "GIF" if src[:3] == b"GIF"
                else "TIFF")
        raise ValueError(f"{name}: {_RASTER_ERRORS.get(rc, rc)}")
    try:
        mode, dtype = RASTER_MODES[meta[0]]
        h, w, entries = meta[1], meta[2], meta[3]
        channels = {"LA": 2, "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}.get(
            mode, 1)
        samples = np.empty((h, w, channels), dtype)
        ctypes.memmove(_ptr(samples), out, samples.nbytes)
        palette = np.empty((entries, 3), np.uint8)
        ctypes.memmove(_ptr(palette),
                       ctypes.addressof(out.contents) + samples.nbytes,
                       palette.nbytes)
    finally:
        library().sn_free(out)
    return mode, samples, palette, int(meta[4]), _RASTER_FORMATS[meta[5]]


def zstd_decompress(data) -> bytes:
    """Every frame of ``data`` decoded (zstd frames, in order; skippable
    frames skipped).  Raises ``ValueError`` for truncated or corrupt input,
    a checksum mismatch or a frame that names a dictionary."""
    return _decoded(library().sn_zstd_decompress, data, "zstd")


def inflate(data) -> bytes:
    """A zlib or gzip stream (told apart by its header) inflated; raises
    ``ValueError`` for one zlib refuses or that ends early."""
    return _decoded(library().sn_inflate, data, "inflate")


def _mp4v_error(code: int) -> ValueError:
    return ValueError(f"MPEG-4 video: {_MP4V_ERRORS.get(code, code)}")


def mp4v_config(width: int, height: int, fps: int) -> bytes:
    """The VOS, VO and VOL headers of the stream ``Mpeg4Encoder`` writes
    for even ``width`` x ``height`` frames at ``fps``: the decoder-specific
    info of an MP4's ``esds``."""
    out = ctypes.create_string_buffer(64)
    n = library().sn_mp4v_config(width, height, fps, out, len(out))
    if n < 0:
        raise _mp4v_error(n)
    return out.raw[:n]


def vol_info(config: bytes) -> Tuple[int, int, int]:
    """(width, height, vop_time_increment_resolution) of the VOL in
    ``config``; ``ValueError`` for one the decoder does not take."""
    src = bytes(config)
    w, h, res = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = library().sn_mp4v_vol_info(src, len(src), ctypes.byref(w),
                                    ctypes.byref(h), ctypes.byref(res))
    if rc:
        raise _mp4v_error(rc)
    return w.value, h.value, res.value


class Mpeg4Encoder:
    """MPEG-4 Part 2 Simple Profile encoder (``mpeg4.cc``): every frame an
    I-VOP at the fixed quantiser ``qp`` (1-31, H.263 quantisation), for
    even ``width`` x ``height`` BGR uint8 frames at ``fps``, on up to
    ``threads`` threads (the GIL released)::

        enc = Mpeg4Encoder(1300, 1192, fps=30, qp=4)
        vop = enc.encode(frame_bgr, index)   # bytes of one MP4 sample
    """

    def __init__(self, width: int, height: int, fps: int, qp: int,
                 threads: int = 1):
        self._lib = library()
        self.width, self.height, self.fps = int(width), int(height), int(fps)
        error = ctypes.c_int()
        self._handle = self._lib.sn_mp4v_encoder_create(
            self.width, self.height, self.fps, int(qp), int(threads),
            ctypes.byref(error))
        if not self._handle:
            raise _mp4v_error(error.value)
        self.config = mp4v_config(self.width, self.height, self.fps)

    def encode(self, frame_bgr: np.ndarray, index: int) -> bytes:
        """One (height, width, 3) uint8 BGR frame as the VOP of frame
        ``index``.  Any strides are read in place (a crop of a larger
        frame, or an RGB array reversed along its last axis, copies
        nothing)."""
        frame = np.asarray(frame_bgr)
        if frame.shape != (self.height, self.width, 3):
            raise ValueError(f"frame shape {frame.shape}, expected "
                             f"{(self.height, self.width, 3)}")
        if frame.dtype != np.uint8:
            frame = frame.astype(np.uint8)
        n = self._lib.sn_mp4v_encoder_encode(self._handle, _ptr(frame),
                                             *frame.strides, int(index))
        if n < 0:
            raise _mp4v_error(n)
        return ctypes.string_at(self._lib.sn_mp4v_encoder_output(
            self._handle), n)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.sn_mp4v_encoder_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def decode_mp4v(config: bytes, sample: bytes, threads: int = 1,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """One VOP of the stream whose VOL is ``config`` -> (H, W, 3) uint8
    BGR, into ``out`` when given.  Only what ``Mpeg4Encoder`` writes is
    read (I-VOPs, H.263 quantisation, rectangular, progressive); anything
    else raises ``ValueError`` naming the reason."""
    cfg, src = bytes(config), bytes(sample)
    w, h, _ = vol_info(cfg)
    if out is None:
        out = np.empty((h, w, 3), np.uint8)
    elif (out.shape != (h, w, 3) or out.dtype != np.uint8
          or not out.flags.c_contiguous):
        raise _mp4v_error(-10)
    rc = library().sn_mp4v_decode(cfg, len(cfg), src, len(src), _ptr(out),
                                  int(threads))
    if rc:
        raise _mp4v_error(rc)
    return out


def mp4v_idct(blocks: np.ndarray, lo: int = -256,
              hi: int = 255) -> np.ndarray:
    """The decoder's 8x8 inverse DCT of (N, 8, 8) integer coefficients,
    rounded and clamped to [lo, hi]."""
    src = np.ascontiguousarray(blocks, np.int32).reshape(-1, 64)
    out = np.empty_like(src)
    library().sn_mp4v_idct(_ptr(src), _ptr(out), len(src), lo, hi)
    return out.reshape(-1, 8, 8)


class FramePrefetcher:
    """Threaded native PNG -> padded CHW decoding over a ring of reusable
    buffers, yielding frames in submission order::

        with FramePrefetcher(paths, pad=(19, 5, 19, 4)) as pf:
            for frame in pf:        # (3, H', W') float32
                ...
    """

    def __init__(self, paths: Sequence[str], pad: Sequence[int] = (0, 0, 0, 0),
                 scale: float = 1.0, slots: int = 4, threads: int = 2):
        self._handle = None
        self._lib = library()
        shape = png_shape(paths[0])
        if shape is None:
            raise ValueError(f"native PNG decoder cannot read {paths[0]!r}")
        h, w, _ = shape
        left, top, right, bottom = pad
        self._shape = (3, top + h + bottom, left + w + right)
        self._paths = list(paths)
        self._handle = self._lib.sn_prefetcher_create(
            slots, self._shape[1], self._shape[2], left, top, right, bottom,
            scale, threads)
        self._submitted = 0
        self._consumed = 0
        while self._submitted < min(len(self._paths), slots):
            self._submit_next()

    def _submit_next(self) -> None:
        self._lib.sn_prefetcher_submit(
            self._handle, os.fsencode(self._paths[self._submitted]))
        self._submitted += 1

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._consumed >= len(self._paths):
            raise StopIteration
        out = np.empty(self._shape, np.float32)
        rc = self._lib.sn_prefetcher_next(self._handle, _ptr(out))
        self._consumed += 1
        if self._submitted < len(self._paths):
            self._submit_next()
        if rc != 0:
            raise RuntimeError(f"native decode failed ({rc}) for "
                               f"{self._paths[self._consumed - 1]!r}")
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.sn_prefetcher_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


__all__ = ["FramePrefetcher", "Mpeg4Encoder", "available", "build_error",
           "decode_jpeg_rgb", "decode_mp4v", "decode_png_hwc",
           "decode_png_padded_chw", "decode_raster", "hwc_to_padded_chw",
           "inflate", "jpeg_info", "library", "mean_pool", "mp4v_config",
           "mp4v_idct", "png_info", "png_shape", "resize_bilinear_chw",
           "rgb_to_gray", "vol_info", "zstd_decompress"]
