"""The image I/O checks of ``chip_smoke.py`` (phase ``io``, and the
fixtures and timings phase ``server`` uses), in a module of their own
beside it; NumPy and the standard library only, as the card's machine has
no imaging library.

``phase_io`` builds the native host runtime (``stereo_tpu_torch/_native``)
and holds every decoder to the committed fixtures: the KITTI frames'
PNGs against the Python decoder, the other PNG kinds (``check_png_cases``),
every JPEG, BMP/TIFF/GIF/PNM/PFM and WebP fixture to the SHA-256s of PIL's
decode in its manifest, a PNG whose header declares 20000x20000 pixels and
one whose sizes would wrap a 64-bit size refused as PIL refuses them
(``check_huge_pngs``), and the host ms of each decoder on the 375x1242
frame.
"""

from __future__ import annotations

import json
import os
import statistics
import struct
import sys
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# The committed KITTI fixture drive: two 375x1242 frames per camera, each
# PNG Paeth-filtered as image libraries write them, and Velodyne scans.
FIXTURE_DRIVE = os.path.join(ROOT, "tests", "fixtures", "kitti", "2011_09_26",
                             "2011_09_26_drive_0001_sync")
FIXTURE_FRAMES = [os.path.join(FIXTURE_DRIVE, side, "data", name)
                  for side in ("image_02", "image_03")
                  for name in ("0000000000.png", "0000000001.png")]
# JPEGs written by Pillow and the SHA-256 of PIL's decode of each
# (tests/fixtures/make_jpeg_fixtures.py); the first frame above as a JPEG
# at quality 90 among them.
JPEG_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "jpeg")
JPEG_FRAME = os.path.join(JPEG_FIXTURES, "kitti_0000000000_q90.jpg")
# BMP, TIFF, GIF, PNM and PFM fixtures with the SHA-256 of PIL's decode.
RASTER_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "raster")
RASTER_GIF = os.path.join(RASTER_FIXTURES, "gif.gif")
# The fixture frame's formats for the host timings and the server: name ->
# content type.
FRAME_FORMATS = {"bmp": "image/bmp", "ppm": "image/x-portable-pixmap",
                 "tiff_raw": "image/tiff", "tiff_lzw": "image/tiff",
                 "tiff_deflate": "image/tiff"}

# WebP files written by Pillow and libwebp's encoder and the SHA-256 of
# PIL's decode of each (tests/fixtures/make_webp_fixtures.py): the first
# frame above as lossy WebP at quality 75, its top 256 rows lossless, and a
# small lossy file with alpha among them.
WEBP_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "webp")
WEBP_FRAME = os.path.join(WEBP_FIXTURES, "kitti_lossy_q75.webp")
WEBP_LOSSLESS = os.path.join(WEBP_FIXTURES, "kitti_lossless_top.webp")
WEBP_ALPHA = os.path.join(WEBP_FIXTURES, "lossy_alpha.webp")


def require(cond: bool, message: str) -> None:
    if not cond:
        raise RuntimeError(message)


def jpeg_manifest() -> dict:
    with open(os.path.join(JPEG_FIXTURES, "expected.json")) as f:
        return json.load(f)


def manifest_checked_jpeg(path: str) -> tuple:
    """A committed JPEG's bytes and the port's decode of it, which must
    hash to the SHA-256 of PIL's decode in the fixtures' manifest."""
    import hashlib

    from stereo_tpu_torch.utils.image_io import decode_image_rgb

    with open(path, "rb") as f:
        data = f.read()
    entry = jpeg_manifest()["files"][os.path.basename(path)]
    rgb = decode_image_rgb(data)
    digest = hashlib.sha256(rgb.tobytes()).hexdigest()
    require(list(rgb.shape) == entry["shape"] and digest == entry["sha256"],
            f"JPEG decode of {path}: shape {rgb.shape}, sha256 {digest}, "
            f"manifest {entry['shape']} {entry['sha256']}")
    return data, rgb


def raster_manifest() -> dict:
    with open(os.path.join(RASTER_FIXTURES, "expected.json")) as f:
        return json.load(f)


def manifest_checked_raster(path: str) -> tuple:
    """A committed BMP/TIFF/GIF/PNM/PFM fixture's bytes and the port's RGB
    decode of it, which must hash to the SHA-256 of PIL's decode in the
    manifest, as its ground-truth array must hash to the JAX trainer's."""
    import hashlib

    from stereo_tpu_torch.utils.image_io import (decode_image,
                                                 decode_image_rgb,
                                                 disparity_of)

    with open(path, "rb") as f:
        data = f.read()
    entry = raster_manifest()["files"][os.path.basename(path)]
    rgb = decode_image_rgb(data)
    digest = hashlib.sha256(rgb.tobytes()).hexdigest()
    disp = hashlib.sha256(disparity_of(decode_image(data)).tobytes())
    require(list(rgb.shape) == entry["shape"] and digest == entry["sha256"]
            and disp.hexdigest() == entry["disparity_sha256"],
            f"decode of {path}: shape {rgb.shape}, sha256 {digest}, "
            f"ground truth {disp.hexdigest()}, manifest {entry}")
    return data, rgb


_FRAME_FILES = {}


def raster_writers() -> tuple:
    """``bmp_file``, ``bmp_rows`` and ``tiff_file`` of
    ``tests/raster_files.py`` (NumPy only: the card's machine has no imaging
    library)."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import raster_files

    return raster_files.bmp_file, raster_files.bmp_rows, raster_files.tiff_file


def frame_files() -> tuple:
    """The fixture frame's pixels ((375, 1242, 3) uint8, its PNG decoded)
    and ``FRAME_FORMATS`` name -> the frame's file bytes: a 24-bit BMP, a
    P6 PPM and RGB TIFFs uncompressed, LZW and Deflate (predictor 2),
    written once by ``tests/raster_files.py``."""
    if not _FRAME_FILES:
        from stereo_tpu_torch.utils.png import decode_png

        bmp_file, bmp_rows, tiff_file = raster_writers()

        with open(FIXTURE_FRAMES[0], "rb") as f:
            frame = decode_png(f.read())
        h, w, _ = frame.shape
        _FRAME_FILES["frame"] = frame
        _FRAME_FILES["files"] = {
            "bmp": bmp_file(w, h, 24, bmp_rows(frame[..., ::-1], 24)),
            "ppm": b"P6 %d %d 255\n" % (w, h) + frame.tobytes(),
            "tiff_raw": tiff_file(frame, 2),
            "tiff_lzw": tiff_file(frame, 2, compression=5),
            "tiff_deflate": tiff_file(frame, 2, compression=8, predictor=2)}
    return _FRAME_FILES["frame"], _FRAME_FILES["files"]


def upload_ms(torch, data: bytes, shape, dev, reps: int = 10) -> float:
    """Host ms of ``decode_png_to_pipeline_image`` to the card, median."""
    from stereo_tpu_torch.serve import decode_png_to_pipeline_image

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_png_to_pipeline_image(data, shape, dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def webp_manifest() -> dict:
    with open(os.path.join(WEBP_FIXTURES, "expected.json")) as f:
        return json.load(f)


def manifest_checked_webp(path: str) -> tuple:
    """A committed WebP fixture's bytes and the port's RGB decode of it,
    which must hash to the SHA-256 of PIL's decode in the manifest, its
    mode be PIL's and its ground-truth array hash to the JAX trainer's."""
    import hashlib

    from stereo_tpu_torch.utils.image_io import (decode_image,
                                                 decode_image_rgb,
                                                 disparity_of)

    with open(path, "rb") as f:
        data = f.read()
    entry = webp_manifest()["files"][os.path.basename(path)]
    rgb = decode_image_rgb(data)
    image = decode_image(data)
    digest = hashlib.sha256(rgb.tobytes()).hexdigest()
    disp = hashlib.sha256(disparity_of(image).tobytes()).hexdigest()
    require(list(rgb.shape) == entry["shape"] and digest == entry["sha256"]
            and image.mode == entry["mode"]
            and disp == entry["disparity_sha256"],
            f"WebP decode of {path}: shape {rgb.shape}, mode {image.mode}, "
            f"sha256 {digest}, ground truth {disp}, manifest {entry}")
    return data, rgb


def huge_png(width: int = 20000, height: int = 20000, depth: int = 8,
             color: int = 2) -> bytes:
    """A PNG whose header declares ``width`` x ``height`` pixels over a
    tiny IDAT (68 bytes at the defaults)."""
    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                         color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"\0" * 10))
            + chunk(b"IEND", b""))


# The huge PNGs: 20000x20000 RGB (400 million pixels), and 2^31 - 1 square
# at 16-bit RGBA, whose raw size would wrap a 64-bit size_t.
HUGE_PNGS = {"rgb_20000x20000": huge_png(),
             "rgba16_2147483647_square": huge_png(2 ** 31 - 1, 2 ** 31 - 1,
                                                  16, 6)}


def check_huge_pngs(reps: int = 20) -> dict:
    """Each huge PNG is a ``BadRequestError`` naming PIL's limit from
    ``decode_image_rgb`` (an upload's decode) and ``decode_image``, and from
    ``read_image_chw`` of it as a file, in under 10 ms (median of
    ``reps``): the port never allocates the declared size."""
    import tempfile

    from stereo_tpu_torch.utils.image_io import (decode_image,
                                                 decode_image_rgb,
                                                 read_image_chw)
    from stereo_tpu_torch.utils.png import MAX_PIXELS, BadRequestError

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in HUGE_PNGS.items():
            path = os.path.join(tmp, "huge.png")
            with open(path, "wb") as f:
                f.write(data)
            ms = {}
            for label, fn in (("decode_image_rgb", decode_image_rgb),
                              ("decode_image", decode_image),
                              ("read_image_chw", lambda _: read_image_chw(
                                  path))):
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    try:
                        fn(data)
                        refused = None
                    except BadRequestError as exc:
                        refused = str(exc)
                    times.append((time.perf_counter() - t0) * 1e3)
                    require(refused is not None
                            and str(MAX_PIXELS) in refused,
                            f"{name} through {label}: {refused}")
                ms[label] = statistics.median(times)
                require(ms[label] < 10,
                        f"{name} through {label} took {ms[label]} ms")
            out[name] = dict(bytes=len(data), refused_ms_median=ms)
    return out


def phase_io() -> dict:
    """The native host runtime: its g++ build, the committed fixture frames
    decoded by it equal byte for byte to the Python decoder, and the host
    ms of a 375x1242 frame for each decoder (the Python one timed once);
    every committed JPEG decoded to its manifest's SHA-256, and the host ms
    of the 375x1242 JPEG frame (median of 20, under the PNG's 50 ms); every
    committed BMP, TIFF, GIF, PNM and PFM fixture decoded to its manifest's
    SHA-256 (RGB and ground truth), and the host ms of ``decode_image_rgb``
    of the fixture frame as a BMP, a PPM and an uncompressed, an LZW and a
    Deflate TIFF (median of 20 each, each under 50 ms, each equal to the
    PNG's pixels); every committed WebP fixture decoded to its manifest's
    SHA-256s and PIL's mode, and the host ms of the 375x1242 lossy frame
    and the 256x1242 lossless one (median of 20, each under 50 ms); the
    huge PNGs refused in under 10 ms (``check_huge_pngs``)."""
    from stereo_tpu_torch import _native
    from stereo_tpu_torch.pipeline.camera.kitti import KITTI_PAD
    from stereo_tpu_torch.utils.image_io import decode_image_rgb
    from stereo_tpu_torch.utils.png import decode_png, decode_png_python

    _native.library()
    frames = []
    python_ms = None
    for path in FIXTURE_FRAMES:
        with open(path, "rb") as f:
            data = f.read()
        native = _native.decode_png_hwc(data)
        t0 = time.perf_counter()
        oracle = decode_png_python(data)
        if python_ms is None:
            python_ms = (time.perf_counter() - t0) * 1e3
        padded = _native.decode_png_padded_chw(path, KITTI_PAD)
        require(np.array_equal(native, oracle)
                and np.array_equal(decode_png(data), oracle)
                and np.array_equal(padded[:, 5:380, 19:1261],
                                   oracle.transpose(2, 0, 1)),
                f"native decode of {path} differs from the Python decoder")
        frames.append(dict(frame=os.path.relpath(path, ROOT),
                           shape=list(native.shape), bytes=len(data),
                           equal_to_python=True))
    with open(FIXTURE_FRAMES[0], "rb") as f:
        data = f.read()

    def host_ms(fn, reps=20):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    native_ms = host_ms(lambda: _native.decode_png_hwc(data))
    require(native_ms < 50, f"native decode took {native_ms} ms")
    names = sorted(jpeg_manifest()["files"])
    for name in names:
        manifest_checked_jpeg(os.path.join(JPEG_FIXTURES, name))
    with open(JPEG_FRAME, "rb") as f:
        jpeg = f.read()
    jpeg_ms = host_ms(lambda: _native.decode_jpeg_rgb(jpeg))
    require(jpeg_ms < 50, f"native JPEG decode took {jpeg_ms} ms")
    raster_names = sorted(raster_manifest()["files"])
    for name in raster_names:
        manifest_checked_raster(os.path.join(RASTER_FIXTURES, name))
    webp_names = sorted(webp_manifest()["files"])
    for name in webp_names:
        manifest_checked_webp(os.path.join(WEBP_FIXTURES, name))
    webp_ms = {}
    for label, path in (("lossy_375x1242", WEBP_FRAME),
                        ("lossless_256x1242", WEBP_LOSSLESS)):
        with open(path, "rb") as f:
            blob = f.read()
        webp_ms[label] = host_ms(lambda: _native.decode_webp(blob))
        require(webp_ms[label] < 50,
                f"native WebP decode of {label} took {webp_ms[label]} ms")
    frame, files = frame_files()
    format_ms = {}
    for name, blob in files.items():
        require(np.array_equal(decode_image_rgb(blob), frame),
                f"the fixture frame as {name} decodes to other pixels")
        format_ms[name] = host_ms(lambda: decode_image_rgb(blob))
        require(format_ms[name] < 50,
                f"{name} decode of the frame took {format_ms[name]} ms")
    return dict(gxx_seconds=round(_native.build_seconds, 3),
                library=os.path.relpath(_native.library_path(), ROOT),
                native_available=_native.available(),
                build_error=_native.build_error(),
                png_cases=check_png_cases(),
                jpeg_fixtures=dict(files=len(names), equal_to_manifest=True),
                frames=frames, python_decode_ms_once=python_ms,
                native_decode_ms=native_ms,
                native_jpeg_decode_ms=jpeg_ms,
                webp_fixtures=dict(files=len(webp_names),
                                   equal_to_manifest=True),
                native_webp_decode_ms=webp_ms,
                huge_pngs=check_huge_pngs(),
                raster_fixtures=dict(files=len(raster_names),
                                     equal_to_manifest=True),
                frame_format_decode_ms=format_ms,
                frame_format_bytes={k: len(v) for k, v in files.items()},
                decode_png_ms=host_ms(lambda: decode_png(data)),
                native_file_padded_ms=host_ms(
                    lambda: _native.decode_png_padded_chw(FIXTURE_FRAMES[0],
                                                          KITTI_PAD)))


# Adam7's passes: (first column, first row, column step, row step).
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def encode_test_png(samples, depth: int, color: int, interlace: bool,
                    palette=None, trns=None) -> bytes:
    """PNG bytes of the stored ``samples`` (H, W, S) at ``depth`` bits,
    plain or Adam7, row r of each pass filtered with type r % 3 (none, Sub,
    Up): an encoder of its own, since the card's machine has no imaging
    library."""
    import struct
    import zlib

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    h, w, s = samples.shape
    bpp = max(1, s * depth // 8)
    raw = bytearray()
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prior = None
        for r, row in enumerate(sub):
            vals = row.reshape(-1).astype(np.int64)
            if depth == 16:
                packed = vals.astype(">u2").tobytes()
            elif depth == 8:
                packed = vals.astype(np.uint8).tobytes()
            else:
                packed = np.packbits(((vals[:, None] >> np.arange(
                    depth - 1, -1, -1)) & 1).reshape(-1).astype(
                        np.uint8)).tobytes()
            cur = np.frombuffer(packed, np.uint8).astype(np.int64)
            up = np.zeros_like(cur) if prior is None else prior
            left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
            pred = (np.zeros_like(cur), left, up)[r % 3]
            raw.append(r % 3)
            raw += ((cur - pred) % 256).astype(np.uint8).tobytes()
            prior = cur
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace))
    body = chunk(b"IHDR", ihdr)
    if palette is not None:
        body += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        body += chunk(b"tRNS", trns.astype(np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n" + body + chunk(b"IDAT", zlib.compress(
        bytes(raw))) + chunk(b"IEND", b""))


def check_png_cases() -> dict:
    """The PNG kinds the decoders take besides 8-bit grey/RGB/RGBA (grey at
    1, 2, 4 and 16 bits, palettes with and without tRNS, grey+alpha, 16-bit
    RGB and RGBA), plain and Adam7: the native samples equal the Python
    oracle's, and the native padded RGB (a file, as the cameras read it)
    equals the oracle's samples mapped as PIL's ``convert("RGB")`` maps
    them (the CPU tests hold that mapping to PIL itself)."""
    import tempfile

    from stereo_tpu_torch import _native
    from stereo_tpu_torch.utils.png import decode_png_python, rgb_like_pil

    rng = np.random.default_rng(30)
    cases = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "case.png")
        for color, depth, trns in ((0, 1, False), (0, 2, False),
                                   (0, 4, False), (0, 16, False),
                                   (3, 4, False), (3, 8, True),
                                   (4, 8, False), (4, 16, False),
                                   (2, 16, False), (6, 16, False)):
            for interlace in (False, True):
                samples_per_pixel = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
                palette = alpha = None
                top = 2 ** depth
                if color == 3:
                    top = min(top, 40)
                    palette = rng.integers(0, 256, (top, 3))
                    alpha = rng.integers(0, 256, top // 2) if trns else None
                elif color == 0 and depth == 16:
                    top = 400                   # PIL clips 16-bit grey
                samples = rng.integers(0, top, (37, 45, samples_per_pixel))
                data = encode_test_png(samples, depth, color, interlace,
                                       palette, alpha)
                oracle = decode_png_python(data)
                native = _native.decode_png_hwc(data)
                with open(path, "wb") as f:
                    f.write(data)
                padded = _native.decode_png_padded_chw(path)
                require(np.array_equal(native, oracle)
                        and np.array_equal(padded, rgb_like_pil(oracle)
                                           .transpose(2, 0, 1)),
                        f"PNG colour type {color}, depth {depth}, tRNS "
                        f"{trns}, interlace {interlace}: native differs "
                        f"from the Python decoder")
                cases += 1
    return dict(cases=cases, equal_to_python=True)
