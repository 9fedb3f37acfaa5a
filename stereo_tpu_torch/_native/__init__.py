"""ctypes bindings of the port's native host runtime (``stereo_native.cc``).

A copy of ``stereo_tpu/_native`` for the port: a zlib PNG decoder (every
colour type, bit depth and interlace, from bytes in memory or from a
file), layout conversions (HWC uint8 -> padded
CHW float32, bilinear resize, mean pool, RGB -> luma) and a threaded frame
prefetcher, and a zstd decoder and zlib/gzip inflation for Orbax
checkpoints (``zstd_decompress``, ``inflate``).  Unlike the JAX package's copy it has no NumPy or imaging
fallback: the library is built with one ``g++ ... -lz`` call on first use
into ``stereo_tpu_torch/_build/`` (named by a hash of the source and the
flags, so a later process reuses it), and a failed build raises with the
compiler's log.  Importing this module builds nothing.  ``available()``
and ``build_error()`` report the build's state (they build on first call);
with no fallback, nothing switches on them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "stereo_native.cc")
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
_IP = ctypes.POINTER(ctypes.c_int)
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
}

_ZSTD_ERRORS = {-1: "truncated input", -2: "corrupt data",
                -3: "the frame names a dictionary, which is not supported",
                -4: "content checksum mismatch",
                -5: "not a zstd or skippable frame",
                -6: "content size differs from the frame header's",
                -7: "out of memory"}


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libstereo_native_{digest.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """One g++ call into a temporary name, then an atomic rename, so that
    processes building at once never load a half-written library."""
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *GXX_FLAGS, SOURCE, "-o", tmp, "-lz"]
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


def zstd_decompress(data) -> bytes:
    """Every frame of ``data`` decoded (zstd frames, in order; skippable
    frames skipped).  Raises ``ValueError`` for truncated or corrupt input,
    a checksum mismatch or a frame that names a dictionary."""
    return _decoded(library().sn_zstd_decompress, data, "zstd")


def inflate(data) -> bytes:
    """A zlib or gzip stream (told apart by its header) inflated; raises
    ``ValueError`` for one zlib refuses or that ends early."""
    return _decoded(library().sn_inflate, data, "inflate")


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


__all__ = ["FramePrefetcher", "available", "build_error", "decode_png_hwc",
           "decode_png_padded_chw", "hwc_to_padded_chw", "inflate",
           "library", "mean_pool", "png_info", "png_shape",
           "resize_bilinear_chw", "rgb_to_gray", "zstd_decompress"]
