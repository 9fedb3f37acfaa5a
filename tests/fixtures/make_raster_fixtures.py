"""Write the committed BMP, TIFF, GIF, PNM and PFM fixtures and their
manifest (run from the repo's root on a machine with Pillow; the card's
machine has none)::

    python tests/fixtures/make_raster_fixtures.py

``tests/fixtures/raster/`` gets one small file for each kind the port's
decoders (``stereo_tpu_torch/_native/raster.cc``, ``utils/pnm.py``) take:
BMPs PIL writes (24-bit, an 8-bit palette, 1-bit) and hand-built ones (the
OS/2 core header, RLE8 and RLE4, 16-bit 565 bitfields, 32-bit bitfields
with alpha, top-down rows); TIFFs PIL writes (LZW, Deflate with predictor
2, PackBits, CMYK, BigTIFF, big-endian 16-bit grey) and hand-built ones
(tiles, planar configuration 2, float with predictor 3, a 4-bit palette,
Orientation 6); GIFs PIL writes (plain and interlaced) and a hand-built
frame smaller than its screen with a transparent index; PNM at maxvals 15,
1023 and 65535, plain P2 and P4, and ``Pf``.  Each is written from a crop
of the committed KITTI frame ``image_02/data/0000000000.png`` or from
seeded numpy samples.  ``expected.json`` holds each file's shape, the
SHA-256 of the bytes of ``Image.open(f).convert("RGB")``, which the JAX
package reads and serves images with, and the SHA-256 of the float32
ground-truth array the JAX stereo trainer reads from it (``np.asarray`` of
the image, channel 0, divided by 256 in modes I and I;16), with the Pillow
and libtiff versions.  ``tests/test_torch_image_formats.py`` holds the
manifest to Pillow and to the port; ``chip_smoke.py`` (phase ``io``) holds
the port's decode on the card's machine to it.
"""

import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image, features

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from raster_files import (bmp_file, bmp_rle, bmp_rows, gif_file,  # noqa: E402
                          tiff_file)
from raster_pil import pil_decode  # noqa: E402

OUT = os.path.join(ROOT, "tests", "fixtures", "raster")
FRAME = os.path.join(ROOT, "tests", "fixtures", "kitti", "2011_09_26",
                     "2011_09_26_drive_0001_sync", "image_02", "data",
                     "0000000000.png")


def save(image: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, fmt, **kw)
    return buf.getvalue()


def variants(frame: np.ndarray) -> dict:
    """File name -> (bytes, what it exercises)."""
    rng = np.random.default_rng(2026)
    crop = np.ascontiguousarray(frame[100:137, 300:353])
    h, w = crop.shape[:2]
    im = Image.fromarray(crop)
    palette = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    idx = np.asarray(im.convert("L")).astype(np.int64)
    bgra = np.dstack([crop[..., ::-1], rng.integers(0, 256, (h, w, 1))])
    grey16 = (idx * 257 + rng.integers(0, 257, (h, w))).astype(np.uint16)
    disp = (np.round(rng.uniform(0, 64, (h, w)) * 256) / 256).astype(
        np.float32)
    return {
        "bmp_24bit.bmp": (save(im, "BMP"), "BMP, 24 bits, PIL"),
        "bmp_8bit_palette.bmp": (save(im.convert(
            "P", palette=Image.Palette.ADAPTIVE, colors=200), "BMP"),
            "BMP, 8-bit palette, PIL"),
        "bmp_1bit.bmp": (save(im.convert("1"), "BMP"), "BMP, 1 bit, PIL"),
        "bmp_os2_4bit.bmp": (bmp_file(w, h, 4, bmp_rows(idx % 16, 4),
                                      palette=palette[:16], header=12),
                             "BMP, OS/2 core header, 4-bit palette"),
        "bmp_rle8.bmp": (bmp_file(w, h, 8, bmp_rle(idx // 16 * 16, False),
                                  palette=palette, compression=1),
                         "BMP, RLE8"),
        "bmp_rle4.bmp": (bmp_file(w, h, 4, bmp_rle(idx // 32, True),
                                  palette=palette[:16], compression=2),
                         "BMP, RLE4"),
        "bmp_565.bmp": (bmp_file(w, h, 16, bmp_rows(
            grey16, 16), header=56, compression=3,
            masks=(0xF800, 0x7E0, 0x1F, 0)), "BMP, 16-bit 565 bitfields"),
        "bmp_32bit_alpha_top_down.bmp": (bmp_file(
            w, h, 32, bmp_rows(bgra[::-1], 32), header=124, compression=3,
            masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000), top_down=True),
            "BMP, 32-bit BGRA bitfields (V5 header), top-down rows"),
        "tiff_lzw.tif": (save(im, "TIFF", compression="tiff_lzw"),
                         "TIFF, LZW, PIL"),
        "tiff_deflate_predictor2.tif": (save(
            im, "TIFF", compression="tiff_adobe_deflate", predictor=2),
            "TIFF, Deflate with predictor 2, PIL"),
        "tiff_packbits_grey.tif": (save(im.convert("L"), "TIFF",
                                        compression="packbits"),
                                   "TIFF, PackBits, grey, PIL"),
        "tiff_cmyk.tif": (save(im.convert("CMYK"), "TIFF"),
                          "TIFF, CMYK, PIL"),
        "tiff_bigtiff.tif": (save(im, "TIFF", big_tiff=True),
                             "BigTIFF, PIL"),
        "tiff_mm_grey16.tif": (tiff_file(grey16, 1, big_endian=True),
                               "TIFF, big-endian 16-bit grey"),
        "tiff_lzw_tiles.tif": (tiff_file(crop, 2, compression=5,
                                         tile=(16, 16)),
                               "TIFF, LZW tiles"),
        "tiff_planar2_deflate.tif": (tiff_file(crop, 2, compression=8,
                                               planar=2, predictor=2),
                                     "TIFF, planar configuration 2, "
                                     "Deflate, predictor 2"),
        "tiff_float_predictor3.tif": (tiff_file(disp, 1, compression=8,
                                                predictor=3),
                                      "TIFF, float32 with predictor 3"),
        "tiff_palette4.tif": (tiff_file((idx % 16).astype(np.uint8), 3, bits=4, colormap=(
            palette[:16].astype(np.int64) * 257)), "TIFF, 4-bit palette"),
        "tiff_orientation6.tif": (tiff_file(crop, 2, compression=5,
                                            orientation=6),
                                  "TIFF, Orientation 6 (PIL rotates it)"),
        "gif.gif": (save(im.convert("P"), "GIF"), "GIF, PIL"),
        "gif_interlaced.gif": (save(im.convert("P"), "GIF", interlace=True),
                               "GIF, interlaced, PIL"),
        "gif_partial_transparent.gif": (gif_file(
            (w + 7, h + 5), (4, 3), idx, global_palette=palette,
            transparency=17), "GIF, a frame smaller than its screen, with "
                              "a transparent index"),
        "pgm_maxval15.pgm": (b"P5 %d %d 15\n" % (w, h) + (idx // 17).astype(
            np.uint8).tobytes(), "PGM at maxval 15"),
        "pgm_16bit.pgm": (b"P5\n%d %d\n65535\n" % (w, h) + grey16.astype(
            ">u2").tobytes(), "PGM at maxval 65535 (mode I)"),
        "ppm_maxval1023.ppm": (b"P6 %d %d 1023\n" % (w, h) + (
            crop.astype(np.int64) * 4).astype(">u2").tobytes(),
            "PPM at maxval 1023"),
        "pgm_plain.pgm": (b"P2\n# plain\n%d %d\n255\n" % (w, h) + b"\n".join(
            b" ".join(b"%d" % v for v in row) for row in idx),
            "plain PGM (P2)"),
        "pbm.pbm": (b"P4 %d %d\n" % (w, h) + np.packbits(
            (idx > 128).astype(np.uint8), axis=1).tobytes(), "PBM (P4)"),
        "disparity.pfm": (b"Pf\n%d %d\n-1.0\n" % (w, h) + disp[::-1].astype(
            "<f4").tobytes(), "PFM, little-endian, bottom-up rows"),
    }


def main() -> None:
    with Image.open(FRAME) as im:
        frame = np.asarray(im.convert("RGB"))
    files = variants(frame)
    os.makedirs(OUT, exist_ok=True)
    manifest = {"pillow": Image.__version__,
                "libtiff": features.version("libtiff"), "files": {}}
    for name, (data, what) in sorted(files.items()):
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        rgb, disp = pil_decode(data)
        manifest["files"][name] = {
            "shape": list(rgb.shape), "bytes": len(data), "what": what,
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
            "disparity_sha256": hashlib.sha256(np.ascontiguousarray(
                disp, np.float32).tobytes()).hexdigest()}
    with open(os.path.join(OUT, "expected.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(files)} files to {os.path.relpath(OUT, ROOT)}")


if __name__ == "__main__":
    main()
