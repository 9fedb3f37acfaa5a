"""Write the committed WebP fixtures and their manifest (run from the
repo's root on a machine with Pillow and libwebp's shared library; the
card's machine has neither)::

    python tests/fixtures/make_webp_fixtures.py

``tests/fixtures/webp/`` gets the files the port's WebP decoder
(``stereo_tpu_torch/_native/webp.cc``) is held to on the card:

* the committed KITTI frame ``image_02/data/0000000000.png`` (375x1242)
  as lossy WebP at quality 75 (the full frame), and lossless (its top 256
  rows, which keep the file under 256 KB);
* crops of the frame (128x96, so that 8 macroblock rows feed 8 token
  partitions) written by libwebp's encoder with the options PIL's ``save``
  does not pass on (``tests/webp_files.encode``): 1, 2, 4 and 8 token
  partitions, the simple and the normal loop filter at each sharpness,
  1-4 segments, alpha raw or compressed under each alpha filter; each
  file's VP8 header is checked to hold what was asked for;
* ALPH chunks built by hand (``webp_files.with_alph``): raw and VP8L
  compressed, each of the three filters;
* animations whose first frame sits at an offset on the canvas (lossless
  and lossy with alpha);
* PIL's lossy with alpha, lossless palettes of 2, 16 and 256 colours, and
  odd sizes.

``expected.json`` holds each file's shape, PIL's mode, the SHA-256 of the
bytes of ``Image.open(f).convert("RGB")`` (which the JAX package reads and
serves images with) and of the float32 ground-truth array the JAX stereo
trainer reads from it (``np.asarray`` of the image, channel 0), with the
Pillow and libwebp versions.  ``tests/test_torch_webp.py`` holds the
manifest to Pillow and to the port; ``chip_smoke.py`` (phases ``io`` and
``server``) holds the port's decode on the card's machine to it.
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

import webp_files as wf  # noqa: E402
from raster_pil import pil_decode  # noqa: E402

OUT = os.path.join(ROOT, "tests", "fixtures", "webp")
FRAME = os.path.join(ROOT, "tests", "fixtures", "kitti", "2011_09_26",
                     "2011_09_26_drive_0001_sync", "image_02", "data",
                     "0000000000.png")
LOSSLESS_ROWS = 256


def save(pixels: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "WEBP", **kw)
    return buf.getvalue()


def encoded(pixels: np.ndarray, want: dict, **options) -> bytes:
    """libwebp's encoding, checked to hold the header fields in ``want``."""
    data = wf.encode(pixels, **options)
    header = wf.vp8_header(data)
    assert all(header[k] == v for k, v in want.items()), (options, header)
    return data


def variants(frame: np.ndarray) -> dict:
    """File name -> (bytes, what it exercises)."""
    rng = np.random.default_rng(2027)
    crop = np.ascontiguousarray(frame[120:248, 400:496])
    small = np.ascontiguousarray(frame[150:214, 700:764])
    alpha = np.clip(rng.normal(160, 60, crop.shape[:2]), 0, 255).astype(
        np.uint8)
    alpha[:, :12] = 255
    alpha[40:60] = 0
    rgba = np.dstack([crop, alpha])
    out = {
        "kitti_lossy_q75.webp": (save(frame, quality=75),
                                 "the KITTI frame, lossy, quality 75"),
        "kitti_lossless_top.webp": (
            save(np.ascontiguousarray(frame[:LOSSLESS_ROWS]), lossless=True),
            f"the KITTI frame's top {LOSSLESS_ROWS} rows, lossless"),
        "lossy_alpha.webp": (save(rgba, quality=80),
                             "lossy with alpha (VP8X, ALPH), PIL"),
    }
    for log2 in range(4):
        out[f"partitions_{1 << log2}.webp"] = (
            encoded(crop, {"partitions": 1 << log2}, partitions=log2,
                    method=2), f"{1 << log2} token partitions")
    for simple in (1, 0):
        for sharpness in range(8):
            kind = "simple" if simple else "normal"
            out[f"filter_{kind}_sharpness{sharpness}.webp"] = (
                encoded(small, {"simple": simple, "sharpness": sharpness},
                        filter_type=1 - simple, filter_sharpness=sharpness,
                        filter_strength=70, autofilter=0),
                f"the {kind} loop filter at sharpness {sharpness}")
    for segments in range(1, 5):
        out[f"segments_{segments}.webp"] = (
            encoded(crop, {"segments": int(segments > 1)}, segments=segments,
                    sns_strength=80), f"{segments} segments")
    for compression in (0, 1):
        for filtering in (0, 1, 2):
            out[f"alpha_c{compression}_f{filtering}.webp"] = (
                wf.encode(rgba, alpha_compression=compression,
                          alpha_filtering=filtering),
                f"libwebp's alpha, compression {compression}, "
                f"filtering {filtering}")
    lossy = save(crop, quality=60)
    for compression in (0, 1):
        for method in range(4):
            out[f"alph_hand_c{compression}_filter{method}.webp"] = (
                wf.with_alph(lossy, alpha, compression, method,
                             lambda g: save(g, lossless=True)),
                f"a hand-built ALPH chunk, compression {compression}, "
                f"filter {method}")
    first = save(small[:40, :50], lossless=True)
    second = save(rgba[:30, :20], quality=50)
    out["anim_lossless_first_at_10_20.webp"] = (
        wf.animation(96, 80, [(10, 20, first), (0, 0, second)]),
        "an animation whose lossless first frame sits at (10, 20)")
    out["anim_lossy_alpha_first_at_30_4.webp"] = (
        wf.animation(96, 80, [(30, 4, second), (0, 0, first)],
                     background=(255, 0, 0, 255)),
        "an animation whose lossy first frame with alpha sits at (30, 4), "
        "on a red ANIM background")
    for colors in (2, 16, 256):
        pal = rng.integers(0, 256, (colors, 3)).astype(np.uint8)
        idx = rng.integers(0, colors, (37, 53))
        out[f"lossless_palette{colors}.webp"] = (
            save(pal[idx], lossless=True), f"lossless, {colors} colours")
    out["lossless_1x1.webp"] = (save(frame[:1, :1], lossless=True),
                                "lossless, 1x1")
    out["lossy_3x5.webp"] = (save(np.ascontiguousarray(frame[:3, :5]),
                                  quality=90), "lossy, 3x5")
    out["lossy_odd_37x53.webp"] = (save(np.ascontiguousarray(
        frame[200:237, 33:86]), quality=90), "lossy, 37x53")
    return out


def main() -> None:
    frame = np.asarray(Image.open(FRAME).convert("RGB"))
    os.makedirs(OUT, exist_ok=True)
    manifest = {"pillow": Image.__version__,
                "libwebp": features.version("webp"), "files": {}}
    for name, (data, what) in sorted(variants(frame).items()):
        assert len(data) < 256 * 1024, (name, len(data))
        rgb, disp = pil_decode(data)
        assert not isinstance(rgb, Exception), (name, rgb)
        with Image.open(io.BytesIO(data)) as im:
            mode = im.mode
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        manifest["files"][name] = {
            "bytes": len(data), "mode": mode, "shape": list(rgb.shape),
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
            "disparity_sha256": hashlib.sha256(np.ascontiguousarray(
                disp, np.float32).tobytes()).hexdigest(),
            "what": what}
    with open(os.path.join(OUT, "expected.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(e["bytes"] for e in manifest["files"].values())
    print(f"{len(manifest['files'])} files, {total} bytes")


if __name__ == "__main__":
    main()
