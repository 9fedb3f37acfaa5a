"""Image and video I/O and grid composition (port of
``stereo_tpu/utils/image_io.py``; NumPy and the standard library only).

Images are CHW float32 in 0..255 unless stated otherwise.  Image files are
told apart by their signature, as PIL tells them apart: PNG and JPEG are
decoded by the native host runtime (``utils/png.py``;
``_native.decode_jpeg_rgb``, ``_native/jpeg.cc``) to the values of PIL's
``convert("RGB")``; BMP, TIFF and GIF (``_native.decode_raster``,
``_native/raster.cc``) and PNM/PFM (``utils/pnm.py``) to PIL's own mode and
samples (``decode_image``), which ``convert_rgb`` converts as PIL's
``convert("RGB")`` does; PNGs are written by ``utils/png.py``.
Video is an mp4 of MPEG-4 Part 2 (``mp4v``) as the JAX package writes it
through OpenCV, here encoded and decoded by the native host runtime
(``_native/mpeg4.cc``) and muxed by ``utils/mp4.py``.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Sequence, Tuple, Union

import numpy as np

from .mp4 import Mp4Writer, read_sample, read_track
from .png import BadRequestError, decode_png_image, decode_png_rgb, encode_png
from .pnm import decode_pnm, is_pnm

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8\xff"   # what PIL's JPEG plugin accepts
_RASTER_SIGNATURES = (b"BM", b"GIF87a", b"GIF89a", b"II*\0", b"MM\0*",
                      b"II+\0", b"MM\0+", b"MM*\0", b"II\0*")
FORMATS = "PNG, JPEG, BMP, TIFF, GIF, PNM (P1-P6) or PFM"
# TIFF's Orientation tag -> the transpose PIL applies when it loads the file
# (ImageOps.exif_transpose), on (H, W, C) samples.
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1], 5: lambda a: a.transpose(1, 0, 2),
           6: lambda a: np.rot90(a, -1), 7: lambda a: np.rot90(a, 2).transpose(
               1, 0, 2), 8: lambda a: np.rot90(a, 1)}

ImageLike = Union[np.ndarray, "object"]  # ndarray or anything np.asarray-able


class DecodedImage(NamedTuple):
    """An image as PIL's ``Image.open`` holds it: its mode ("1", "L", "P",
    "LA", "PA", "RGB", "RGBA", "CMYK", "I;16", "I" or "F"), its (H, W, C)
    samples (mode "1" as 0 or 255) and, for "P" and "PA", the palette's
    (N, 3) uint8 RGB."""
    mode: str
    samples: np.ndarray
    palette: np.ndarray


def decode_image(data: bytes) -> DecodedImage:
    """Image bytes (any format ``decode_image_rgb`` takes) ->
    ``DecodedImage``, what PIL's ``Image.open`` decodes before any
    conversion (TIFF's Orientation applied, as PIL applies it when it loads
    the file).  The format is told by the signature.  A file PIL refuses,
    or another format, is a ``BadRequestError`` naming the format and the
    cause; so is a variant PIL opens and the port does not (TIFF with JPEG,
    CCITT, LZMA, ZSTD or WebP compression, or in YCbCr or CIELab), by its
    name."""
    from .. import _native

    no_palette = np.zeros((0, 3), np.uint8)
    if data[:len(_PNG_SIGNATURE)] == _PNG_SIGNATURE:
        return DecodedImage(*decode_png_image(data))
    try:
        if data[:len(_JPEG_SIGNATURE)] == _JPEG_SIGNATURE:
            return DecodedImage(*_native.decode_jpeg(data), no_palette)
        if is_pnm(data):
            return DecodedImage(*decode_pnm(data), no_palette)
        if data[:6].startswith(_RASTER_SIGNATURES):
            mode, samples, palette, orientation, _ = _native.decode_raster(
                data)
            if orientation in _ORIENT:
                samples = np.ascontiguousarray(_ORIENT[orientation](samples))
            return DecodedImage(mode, samples, palette)
    except ValueError as exc:
        raise BadRequestError(str(exc)) from exc
    raise BadRequestError(f"not a {FORMATS} image")


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def convert_rgb(image: DecodedImage) -> np.ndarray:
    """``DecodedImage`` -> (H, W, 3) uint8, PIL's ``convert("RGB")``: alpha
    dropped, a palette index past the palette black (its ``transparency``
    ignored), "1" as 0 or 255, "I;16" and "I" clipped to 0..255, "F"
    truncated toward zero and clipped (NaN as 0), CMYK as PIL maps it."""
    mode, samples = image.mode, image.samples
    if mode in ("P", "PA"):
        palette = np.zeros((256, 3), np.uint8)
        palette[:len(image.palette)] = image.palette[:256]
        return palette[samples[..., 0]]
    if mode in ("RGB", "RGBA"):
        return np.ascontiguousarray(samples[..., :3], np.uint8)
    if mode == "CMYK":
        cmyk = samples.astype(np.int32)
        nk = 255 - cmyk[..., 3:]
        return np.clip(nk - _muldiv255(cmyk[..., :3], nk), 0,
                       255).astype(np.uint8)
    grey = samples[..., 0]
    if mode in ("I;16", "I"):
        grey = np.clip(grey, 0, 255)
    elif mode == "F":
        grey = np.clip(np.trunc(np.nan_to_num(grey, nan=0.0, posinf=255.0,
                                              neginf=0.0)), 0, 255)
    return np.repeat(grey.astype(np.uint8)[..., None], 3, axis=2)


def disparity_of(image: DecodedImage) -> np.ndarray:
    """``DecodedImage`` -> (H, W) float32, the JAX stereo trainer's reading
    of a ground-truth file: ``np.asarray(im, float32)``, its first channel,
    divided by 256 in modes "I" and "I;16" (KITTI's encoding)."""
    mode, samples = image.mode, image.samples
    disp = samples[..., 0].astype(np.float32)
    if mode == "1":
        return (disp != 0).astype(np.float32)
    if mode in ("I;16", "I"):
        return disp / np.float32(256.0)
    return disp


def decode_image_rgb(data: bytes) -> np.ndarray:
    """Image bytes -> (H, W, 3) uint8 RGB, the values of PIL's
    ``Image.open(...).convert("RGB")``, which the JAX package reads and
    serves images with.  The format is the one the bytes' signature names,
    whatever a file name says: PNG, JPEG, BMP, TIFF, GIF, PNM or PFM
    (``decode_image`` and ``convert_rgb`` for the last five); anything
    else, and a file PIL would refuse, is a ``BadRequestError`` (a
    ``ValueError``) naming the format and the cause.  JPEG
    (``_native/jpeg.cc``): baseline, extended and progressive
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
    return convert_rgb(decode_image(data))


def read_image_chw(path: str) -> np.ndarray:
    """Decode an image file (PNG of any colour type, bit depth or
    interlace, JPEG, BMP, TIFF, GIF, PNM or PFM) to (3, H, W) float32 in
    0..255, with the values of PIL's ``convert("RGB")``, which the JAX
    package reads image files with.  The format is told by the file's
    signature, not its name; other formats raise ``ValueError``."""
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


# --- mp4v video --------------------------------------------------------------

# The encoder's quantiser (1-31, H.263 quantisation, every frame intra),
# chosen with ``tests/video_floor.py``: the lowest at which the file is
# at least as sharp as OpenCV's on every frame shape the tests hold it to.
VIDEO_QUANTISER = 4


def _threads() -> int:
    """Macroblock-row threads of the video encoder and decoder."""
    return min(4, len(os.sched_getaffinity(0)))


class Mp4vWriter:
    """Streams BGR uint8 (H, W, 3) frames into an MP4 of MPEG-4 Part 2
    video (``mp4v``, ``_native/mpeg4.cc``, muxed by ``utils/mp4.py``),
    with OpenCV's ``VideoWriter`` contract: ``write(frame_bgr)`` per frame,
    ``release()`` at the end.  Odd widths and heights are cropped to even,
    as OpenCV crops them (the last column or row is dropped)."""

    def __init__(self, path: str, height: int, width: int, fps: int):
        from .. import _native

        self._shape = (int(height), int(width), 3)
        self._h, self._w = self._shape[0] & ~1, self._shape[1] & ~1
        self._encoder = _native.Mpeg4Encoder(self._w, self._h, fps,
                                             VIDEO_QUANTISER, _threads())
        self._mp4 = Mp4Writer(path, self._w, self._h, fps,
                              self._encoder.config)
        self._index = 0

    def write(self, frame_bgr: np.ndarray) -> None:
        frame = np.asarray(frame_bgr, np.uint8)
        if frame.shape != self._shape:
            raise ValueError(f"frame shape {frame.shape}, expected "
                             f"{self._shape}")
        self._mp4.write(self._encoder.encode(frame[:self._h, :self._w],
                                             self._index))
        self._index += 1

    def release(self) -> None:
        self._mp4.close()
        self._encoder.close()


def open_video_writer(path: str, height: int, width: int,
                      fps: int) -> Mp4vWriter:
    """Open a streaming mp4 writer; callers ``.write()`` BGR uint8 frames
    incrementally and ``.release()`` when done, so memory stays flat over
    the video's length."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return Mp4vWriter(path, height, width, fps)


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
    """Read an mp4 written by ``Mp4vWriter`` -> ((T, H, W, 3) uint8 RGB,
    fps); ``ValueError`` naming MP4 or MPEG-4 video for any other file."""
    from .. import _native

    track = read_track(path)
    frames = np.empty((len(track.sizes), track.height, track.width, 3),
                      np.uint8)
    bgr = np.empty(frames.shape[1:], np.uint8)
    with open(path, "rb") as f:
        for i in range(len(track.sizes)):
            _native.decode_mp4v(track.config, read_sample(f, track, i),
                                _threads(), out=bgr)
            frames[i] = bgr[:, :, ::-1]
    return frames, track.fps
