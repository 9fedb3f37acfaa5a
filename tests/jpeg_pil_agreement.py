"""Holds the port's JPEG decoder to PIL on seeded damaged files, many more
than ``tests/test_torch_jpeg.py`` runs (a check by hand, not a test)::

    python tests/jpeg_pil_agreement.py [--seeds 8] [--per-seed 1500]

Three kinds of files, each from PIL-written crops of the committed KITTI
frame (and noise) in grey, RGB and CMYK, baseline, progressive, optimized
and restart-marked:
- ``small``: 40x70 files with one to three random byte changes,
  deletions or insertions;
- ``large``: files of 3-194 KB (past PIL's 64 KiB reads) with bytes
  changed or cut near the end;
- ``eoi_cut``: seeded crops and settings with one or two bytes cut off,
  where PIL decodes a single-scan file only when libjpeg never read past
  the last byte.
For each, the counts of files both decode to equal pixels, both refuse,
and where they part (``differ``, ``port_only_refuses``,
``pil_only_refuses``), printed as one JSON line.  Needs PIL and g++ (the
native library builds on first use); about a minute a 1500 files.
"""

import argparse
import io
import json
import os
import sys
import warnings

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from stereo_tpu_torch import _native  # noqa: E402

FRAME = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                     "kitti", "2011_09_26", "2011_09_26_drive_0001_sync",
                     "image_02", "data", "0000000000.png")


def jpeg(image, mode="RGB", **save):
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(image)).convert(mode).save(
        buf, "JPEG", **save)
    return buf.getvalue()


def compare(data: bytes, counts: dict) -> None:
    try:
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im.convert("RGB"))
    except Exception:  # noqa: BLE001 - any refusal
        want = None
    try:
        got = _native.decode_jpeg_rgb(data)
    except ValueError:
        got = None
    if want is None:
        key = "both_refuse" if got is None else "pil_only_refuses"
    elif got is None:
        key = "port_only_refuses"
    else:
        key = "equal" if np.array_equal(got, want) else "differ"
    counts[key] = counts.get(key, 0) + 1


def mutate(rng, data: bytes, edits: int) -> bytes:
    data = bytearray(data)
    for _ in range(edits):
        at, n = int(rng.integers(2, len(data))), int(rng.integers(1, 8))
        op = rng.integers(3)
        if op == 0:
            data[at] = int(rng.integers(256))
        elif op == 1:
            del data[at:at + n]
        else:
            data[at:at] = rng.integers(0, 256, n, np.uint8).tobytes()
    return bytes(data)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, default=8)
    parser.add_argument("--per-seed", type=int, default=1500)
    args = parser.parse_args()
    warnings.simplefilter("ignore")
    with Image.open(FRAME) as im:
        frame = np.asarray(im.convert("RGB"))
    saves = [{}, {"progressive": True},
             {"subsampling": 0, "restart_marker_blocks": 2},
             {"optimize": True, "subsampling": 1},
             {"progressive": True, "restart_marker_rows": 1}]
    small = [jpeg(frame[:40, :70], mode, quality=80, **save)
             for save in saves for mode in ("RGB", "L", "CMYK")]
    noise = np.random.default_rng(0).integers(0, 256, (260, 300, 3),
                                              np.uint8)
    large = [jpeg(img, mode, **{"quality": 85, **save})
             for img, kind_saves in (
                 (frame[:120, :300], [{}, {"subsampling": 0},
                                      {"optimize": True}]),
                 (frame, [{}, {"subsampling": 1, "quality": 95}]),
                 (noise, [{"quality": 95},
                          {"quality": 95, "subsampling": 0}]))
             for save in kind_saves for mode in ("RGB", "L")]
    result = {"small": {}, "large": {}, "eoi_cut": {}}
    for seed in range(args.seeds):
        rng = np.random.default_rng(seed)
        for _ in range(args.per_seed):
            base = small[int(rng.integers(len(small)))]
            compare(mutate(rng, base, int(rng.integers(1, 4))),
                    result["small"])
        for _ in range(args.per_seed // 4):
            data = large[int(rng.integers(len(large)))]
            cut = int(rng.integers(1, 40))
            data = data[:-cut] if rng.random() < 0.5 else mutate(
                rng, data, int(rng.integers(1, 3)))
            compare(data, result["large"])
        for _ in range(args.per_seed // 4):
            h, w = int(rng.integers(8, 376)), int(rng.integers(8, 1243))
            y, x = int(rng.integers(0, 376 - h)), int(rng.integers(0, 1243 - w))
            save = {"quality": int(rng.integers(30, 100)),
                    "subsampling": int(rng.integers(0, 3))}
            if rng.random() < 0.3:
                save["restart_marker_blocks"] = int(rng.integers(1, 9))
            data = jpeg(frame[y:y + h, x:x + w],
                        "L" if rng.random() < 0.25 else "RGB", **save)
            compare(data[:-int(rng.integers(1, 3))], result["eoi_cut"])
    print(json.dumps(dict(result, pillow=Image.__version__,
                          seeds=args.seeds, per_seed=args.per_seed)))


if __name__ == "__main__":
    main()
