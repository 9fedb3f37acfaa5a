"""Write the committed JPEG fixtures and their manifest (run from the repo's
root on a machine with Pillow; the card's machine has none)::

    python tests/fixtures/make_jpeg_fixtures.py

``tests/fixtures/jpeg/`` gets one small JPEG for each kind of file the
port's decoder (``stereo_tpu_torch/_native/jpeg.cc``) takes: baseline at
4:4:4, 4:2:2 and 4:2:0, progressive, optimized Huffman tables, restart
markers by blocks and by rows, grey, CMYK (Adobe), RGB kept by an Adobe
marker, an EXIF block with Orientation 6, an APP1 that holds a whole JPEG
thumbnail, quality 1 at 8x2100, and a progressive file whose last scan is
left out (libjpeg smooths its blocks); and ``kitti_0000000000_q90.jpg``,
the committed KITTI frame ``image_02/data/0000000000.png`` (375x1242)
written at quality 90.  Each is written by Pillow from the KITTI frame or
from seeded numpy pixels.  ``expected.json`` holds each file's shape and
the SHA-256 of the bytes of ``Image.open(f).convert("RGB")``, which the
JAX package reads and serves images with, and the Pillow and libjpeg-turbo
versions that decoded them.  ``tests/test_torch_jpeg.py`` holds the
manifest to Pillow's decode of the committed files and to the port's;
``chip_smoke.py`` (phases ``io`` and ``server``) holds the port's decode on
the card's machine to the manifest.
"""

import hashlib
import io
import json
import os

import numpy as np
from PIL import Image, features

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "tests", "fixtures", "jpeg")
FRAME = os.path.join(ROOT, "tests", "fixtures", "kitti", "2011_09_26",
                     "2011_09_26_drive_0001_sync", "image_02", "data",
                     "0000000000.png")


def last_scan_dropped(data: bytes) -> bytes:
    """A progressive file without its last scan (EOI kept)."""
    return data[:data.rfind(b"\xff\xda")] + b"\xff\xd9"


def variants(frame: np.ndarray) -> dict:
    """File name -> (JPEG bytes, what it exercises)."""
    rng = np.random.default_rng(2026)
    crop = Image.fromarray(np.ascontiguousarray(frame[100:137, 300:353]))
    odd = Image.fromarray(np.ascontiguousarray(frame[200:217, 600:631]))
    y, x = np.mgrid[0:40, 0:56]
    gradient = Image.fromarray(np.stack(
        [x * 4, y * 6, (x + y) * 2], -1).astype(np.uint8))
    noise = Image.fromarray(rng.integers(0, 256, (24, 40, 3), np.uint8))
    exif = Image.Exif()
    exif[0x0112] = 6
    thumb = io.BytesIO()
    Image.fromarray(frame[:16, :16]).save(thumb, "JPEG", quality=50)

    def save(im, **kw):
        buf = io.BytesIO()
        im.save(buf, "JPEG", **kw)
        return buf.getvalue()

    progressive = save(crop, quality=75, subsampling=2, progressive=True)
    return {
        "baseline_444_q90.jpg": (save(crop, quality=90, subsampling=0),
                                 "baseline 4:4:4"),
        "baseline_422_q50.jpg": (save(noise, quality=50, subsampling=1),
                                 "baseline 4:2:2, noise"),
        "baseline_420_q100_17x31.jpg": (
            save(odd, quality=100, subsampling=2),
            "baseline 4:2:0 at odd width and height"),
        "progressive_420.jpg": (progressive, "progressive 4:2:0"),
        "optimize_422.jpg": (save(gradient, quality=90, subsampling=1,
                                  optimize=True),
                             "optimized Huffman tables, smooth gradient"),
        "restart_blocks_420.jpg": (
            save(crop, quality=90, subsampling=2, restart_marker_blocks=3),
            "restart interval of 3 MCUs"),
        "restart_rows_progressive.jpg": (
            save(crop, quality=90, subsampling=2, progressive=True,
                 restart_marker_rows=1),
            "progressive with a restart interval of one MCU row"),
        "grey.jpg": (save(crop.convert("L"), quality=90), "one component"),
        "cmyk.jpg": (save(crop.convert("CMYK"), quality=90),
                     "CMYK under an Adobe marker"),
        "keep_rgb.jpg": (save(crop, quality=90, keep_rgb=True),
                         "RGB kept by an Adobe marker with transform 0"),
        "exif_orientation6.jpg": (
            save(crop, quality=90, exif=exif.tobytes()),
            "EXIF Orientation 6, decoded unrotated"),
        "app1_thumbnail.jpg": (
            save(crop, quality=90,
                 exif=b"Exif\0\0" + bytes(8) + thumb.getvalue()),
            "an APP1 segment that holds a whole JPEG"),
        "q1_8x2100.jpg": (
            save(Image.fromarray(np.ascontiguousarray(
                np.tile(frame[:8, :1050], (1, 2, 1)))), quality=1),
            "quality 1, 8x2100"),
        "progressive_smoothed.jpg": (
            last_scan_dropped(progressive),
            "progressive without its last scan: block smoothing"),
    }


def main() -> None:
    with Image.open(FRAME) as im:
        frame = np.asarray(im.convert("RGB"))
    files = variants(frame)
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "JPEG", quality=90)
    files["kitti_0000000000_q90.jpg"] = (
        buf.getvalue(), "the KITTI fixture frame at quality 90")
    os.makedirs(OUT, exist_ok=True)
    manifest = {"pillow": Image.__version__,
                "libjpeg_turbo": features.version("libjpeg_turbo"),
                "files": {}}
    for name, (data, what) in sorted(files.items()):
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        with Image.open(io.BytesIO(data)) as im:
            rgb = np.asarray(im.convert("RGB"))
        manifest["files"][name] = {
            "shape": list(rgb.shape), "bytes": len(data), "what": what,
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    with open(os.path.join(OUT, "expected.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(files)} files to {os.path.relpath(OUT, ROOT)}")


if __name__ == "__main__":
    main()
