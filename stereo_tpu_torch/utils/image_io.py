"""Image and video I/O and grid composition (port of
``stereo_tpu/utils/image_io.py``; NumPy and the standard library only).

Images are CHW float32 in 0..255 unless stated otherwise.  PNG and JPEG
files are told apart by their signature, as PIL tells them apart, and
decoded by the native host runtime (``utils/png.py``;
``_native.decode_jpeg_rgb``, ``_native/jpeg.cc``) to the values of PIL's
``convert("RGB")``; PNGs are written by ``utils/png.py``.
Video is an uncompressed RGB AVI (RIFF, ``00db`` DIB frames): the JAX
package writes mp4 through OpenCV, which the card's machine does not have.
The frames and their order are the same.
"""

from __future__ import annotations

import os
import struct
from typing import List, Sequence, Tuple, Union

import numpy as np

from .png import BadRequestError, decode_png_rgb, encode_png

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8\xff"   # what PIL's JPEG plugin accepts

ImageLike = Union[np.ndarray, "object"]  # ndarray or anything np.asarray-able


def decode_image_rgb(data: bytes) -> np.ndarray:
    """PNG or JPEG bytes -> (H, W, 3) uint8 RGB, the values of PIL's
    ``Image.open(...).convert("RGB")``, which the JAX package reads and
    serves images with.  The format is the one the bytes' signature names,
    whatever a file name says; anything else, and a file PIL would refuse,
    is a ``BadRequestError`` (a ``ValueError``) naming the format and the
    cause.  JPEG (``_native/jpeg.cc``): baseline, extended and progressive
    Huffman files at 8 bits, 1, 3 or 4 components, any sampling factors
    1-4, restart markers, the colour space libjpeg picks, CMYK and YCCK as
    PIL converts them, block smoothing, damaged streams as libjpeg reads
    them; EXIF orientation is not applied (PIL does not apply it);
    arithmetic-coded, lossless, hierarchical and 12-bit files are refused
    by name."""
    from .. import _native

    if data[:len(_PNG_SIGNATURE)] == _PNG_SIGNATURE:
        return decode_png_rgb(data)
    if data[:len(_JPEG_SIGNATURE)] == _JPEG_SIGNATURE:
        try:
            return _native.decode_jpeg_rgb(data)
        except ValueError as exc:
            raise BadRequestError(str(exc)) from exc
    raise BadRequestError("not a PNG or JPEG image")


def read_image_chw(path: str) -> np.ndarray:
    """Decode a PNG (any colour type, bit depth or interlace) or JPEG file
    to (3, H, W) float32 in 0..255 with the native decoders, with the
    values of PIL's ``convert("RGB")``, which the JAX package reads image
    files with.  The format is told by the file's signature, not its name;
    other formats raise ``ValueError``."""
    from .. import _native

    with open(path, "rb") as f:
        head = f.read(len(_PNG_SIGNATURE))
        if head != _PNG_SIGNATURE:
            return _native.hwc_to_padded_chw(decode_image_rgb(head + f.read()))
    return _native.decode_png_padded_chw(path)


def write_image_chw(path: str, image_chw: np.ndarray) -> None:
    """(3, H, W) or (H, W) float array in 0..255 -> PNG file (rounded and
    clipped to uint8)."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"can only write PNG files, got {path!r}")
    arr = np.asarray(image_chw)
    if arr.ndim == 3:
        arr = arr.transpose(1, 2, 0)
    arr = np.clip(np.round(arr), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(arr))


def pad_image(image: np.ndarray, left: int, top: int, right: int, bottom: int,
              fill: float = 0.0) -> np.ndarray:
    """Constant-pad the trailing (H, W) axes (torchvision ``T.Pad`` order:
    left, top, right, bottom)."""
    pad = [(0, 0)] * (image.ndim - 2) + [(top, bottom), (left, right)]
    return np.pad(image, pad, constant_values=fill)


def normalize_image(image: ImageLike) -> np.ndarray:
    """0..255 -> 0..~1 (divided by 256, as the reference does)."""
    return np.asarray(image, dtype=np.float32) / 256.0


def ensure_chw(image: np.ndarray) -> np.ndarray:
    """(H, W) -> (3, H, W) by channel replication; (3, H, W) passes through."""
    arr = np.asarray(image)
    if arr.ndim == 3:
        return arr
    return np.tile(arr[None], (3, 1, 1))


def make_image_grid(images: Sequence[np.ndarray], padding: int = 10,
                    pad_value: float = 1.0) -> np.ndarray:
    """Stack (3, H, W) images into one vertical grid with padded borders:
    (3, H', W') float32, one image per row."""
    chw = [ensure_chw(im).astype(np.float32) for im in images]
    h = max(im.shape[1] for im in chw)
    w = max(im.shape[2] for im in chw)
    n = len(chw)
    gh = n * h + (n + 1) * padding
    gw = w + 2 * padding
    grid = np.full((3, gh, gw), pad_value, dtype=np.float32)
    for i, im in enumerate(chw):
        y0 = padding + i * (h + padding)
        grid[:, y0:y0 + im.shape[1], padding:padding + im.shape[2]] = im
    return grid


def prepare_image_grid(images: Union[ImageLike, List[ImageLike]]) -> List[np.ndarray]:
    """Normalize and channel-expand a list of images."""
    if not isinstance(images, list):
        images = [images]
    return [ensure_chw(normalize_image(np.asarray(im))) for im in images]


def save_image_grid(images: Union[ImageLike, List[ImageLike]], file_path: str,
                    padding: int = 10, pad_value: float = 1.0) -> None:
    """Save images as one grid PNG."""
    grid = make_image_grid(prepare_image_grid(images), padding, pad_value)
    write_image_chw(file_path, grid * 255.0)


def read_kitti_drive_stereo_pairs(drive_dir: str) -> Tuple[List[str], List[str]]:
    """List (left, right) image paths of a KITTI raw drive (``image_02/data``
    and ``image_03/data``)."""
    left_dir = os.path.join(drive_dir, "image_02", "data")
    right_dir = os.path.join(drive_dir, "image_03", "data")
    for d, side in ((left_dir, "left"), (right_dir, "right")):
        if not os.path.exists(d):
            raise RuntimeError(f"Folder for {side} images not found: {d}.")
    lefts = [os.path.join(left_dir, f) for f in os.listdir(left_dir)]
    rights = [os.path.join(right_dir, f) for f in os.listdir(right_dir)]
    return lefts, rights


# --- uncompressed AVI ------------------------------------------------------

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10
_RIFF_LIMIT = 2 ** 32 - 1


class AviWriter:
    """Streams BGR uint8 (H, W, 3) frames into an uncompressed AVI: 24-bit
    DIB frames (rows bottom-up, each padded to 4 bytes) in ``00db`` chunks,
    then an ``idx1`` index.  ``write`` and ``release`` as OpenCV's
    ``VideoWriter``; the frame count and sizes are patched in on
    ``release``."""

    def __init__(self, path: str, height: int, width: int, fps: int):
        self._h, self._w, self._fps = int(height), int(width), int(fps)
        self._stride = (3 * self._w + 3) & ~3
        self._frame_bytes = self._stride * self._h
        self._index: List[Tuple[int, int]] = []
        self._file = open(path, "wb")
        self._write_headers()

    def _write_headers(self) -> None:
        f, h, w = self._file, self._h, self._w
        avih = struct.pack("<10I16x", round(1e6 / self._fps),
                           self._frame_bytes * self._fps, 0, _AVIF_HASINDEX,
                           0, 0, 1, self._frame_bytes, w, h)
        strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"DIB ", 0, 0, 0,
                           0, 1, self._fps, 0, 0, self._frame_bytes,
                           0xFFFFFFFF, 0, 0, 0, w, h)
        strf = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0,
                           self._frame_bytes, 0, 0, 0, 0)
        strl = (b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf))
        hdrl = b"hdrl" + _chunk(b"avih", avih) + _chunk(b"LIST", strl)
        f.write(b"RIFF" + struct.pack("<I", 0) + b"AVI ")
        f.write(_chunk(b"LIST", hdrl))
        # Offsets of the fields patched in on release: the hdrl list's
        # body starts at byte 20, avih's body at 32 (its fifth field is the
        # frame count), strl's body after avih and strl's own chunk header,
        # strh's body 12 bytes into it (its ninth field is the length).
        self._total_frames_at = 32 + 16
        strl_at = 20 + len(hdrl) - len(strl)
        self._length_at = strl_at + 4 + 8 + 32
        self._movi_at = f.tell()
        f.write(b"LIST" + struct.pack("<I", 0) + b"movi")

    def write(self, frame_bgr: np.ndarray) -> None:
        frame = np.asarray(frame_bgr, np.uint8)
        if frame.shape != (self._h, self._w, 3):
            raise ValueError(f"frame shape {frame.shape}, expected "
                             f"{(self._h, self._w, 3)}")
        if self._file.tell() + 8 + self._frame_bytes + 16 * (
                len(self._index) + 1) > _RIFF_LIMIT:
            raise RuntimeError("uncompressed AVI would pass 4 GiB")
        rows = np.zeros((self._h, self._stride), np.uint8)
        rows[:, :3 * self._w] = frame[::-1].reshape(self._h, -1)
        self._index.append((self._file.tell() - (self._movi_at + 8),
                            self._frame_bytes))
        self._file.write(_chunk(b"00db", rows.tobytes()))

    def release(self) -> None:
        if self._file.closed:
            return
        f = self._file
        movi_end = f.tell()
        f.write(b"idx1" + struct.pack("<I", 16 * len(self._index)))
        for offset, size in self._index:
            f.write(struct.pack("<4sIII", b"00db", _AVIIF_KEYFRAME, offset,
                                size))
        end = f.tell()
        for at, value in ((4, end - 8),
                          (self._movi_at + 4, movi_end - self._movi_at - 8),
                          (self._total_frames_at, len(self._index)),
                          (self._length_at, len(self._index))):
            f.seek(at)
            f.write(struct.pack("<I", value))
        f.close()


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(body)) + body


def open_video_writer(path: str, height: int, width: int, fps: int) -> AviWriter:
    """Open a streaming video writer; callers ``.write()`` BGR uint8 frames
    incrementally and ``.release()`` when done, so memory stays flat over
    the video's length."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return AviWriter(path, height, width, fps)


def write_video(path: str, frames_thwc: np.ndarray, fps: int) -> None:
    """Write a (T, H, W, 3) uint8 RGB frame stack as a video."""
    t, h, w, _ = frames_thwc.shape
    writer = open_video_writer(path, h, w, fps)
    try:
        for frame in frames_thwc:
            writer.write(frame[:, :, ::-1])  # RGB -> BGR
    finally:
        writer.release()


def read_video(path: str) -> Tuple[np.ndarray, int]:
    """Read an AVI written by ``AviWriter`` -> ((T, H, W, 3) uint8 RGB, fps)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path!r} is not an AVI file")
    chunks = {}        # top-level chunk or list type -> body offset
    pos = 12
    while pos + 8 <= len(data):
        fourcc, size = struct.unpack_from("<4sI", data, pos)
        key = data[pos + 8:pos + 12] if fourcc == b"LIST" else fourcc
        chunks[key] = pos + 8
        pos += 8 + size + (size & 1)
    hdrl, movi, idx1 = chunks[b"hdrl"], chunks[b"movi"], chunks[b"idx1"]
    fps = round(1e6 / struct.unpack_from("<I", data, hdrl + 12)[0])
    strf = data.index(b"strf", hdrl) + 8
    _, w, h, _, bits = struct.unpack_from("<IiiHH", data, strf)
    if bits != 24 or h <= 0:
        raise ValueError(f"unsupported AVI frames ({bits} bits, height {h})")
    stride = (3 * w + 3) & ~3
    n = struct.unpack_from("<I", data, idx1 - 4)[0] // 16
    frames = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        _, _, offset, size = struct.unpack_from("<4sIII", data, idx1 + 16 * i)
        start = movi + offset + 8      # offsets count from the "movi" type
        rows = np.frombuffer(data, np.uint8, size, start).reshape(h, stride)
        frames[i] = rows[::-1, :3 * w].reshape(h, w, 3)[:, :, ::-1]
    return frames, fps
