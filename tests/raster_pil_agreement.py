"""Holds the port's BMP, TIFF, GIF and PNM/PFM decoders to PIL on thousands
of seeded damaged files, and counts every disagreement (not collected by
pytest; PIL, the JAX package's reader, is the reference)::

    python tests/raster_pil_agreement.py [--files 6000] [--seed 0]

Each file is one of ``tests/test_torch_image_formats.py``'s variants (the
files PIL writes and the hand-built ones), cut at a seeded length, with
one to four seeded bytes replaced, or (a TIFF) with one size entry
(ImageWidth, ImageLength, RowsPerStrip, TileWidth, TileLength) set to a
seeded value at the edge of a C int or a 64-bit size, or with one entry's
type replaced (bytes, text, rationals, floats, the signed and 64-bit
integers, IFD offsets).  PIL either decodes it (the port must
give the same ``convert("RGB")`` pixels and the same ground-truth array)
or refuses it (the port must raise ``BadRequestError``).  Prints one JSON
line: the files, the counts of each outcome by format and damage, and the
first disagreements (variant, damage, seed and what differed).
"""

import argparse
import collections
import json
import os
import sys
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import test_torch_image_formats as cases  # noqa: E402
from raster_files import damaged  # noqa: E402
from raster_pil import pil_decode  # noqa: E402

from stereo_tpu_torch.utils.image_io import (  # noqa: E402
    BadRequestError, convert_rgb, decode_image, disparity_of)


def outcome(data: bytes) -> str:
    """"agree", "both_refuse", "differ", "pil_only_refuses" or
    "port_only_refuses"."""
    want, want_disp = pil_decode(data)
    try:
        image = decode_image(data)
        got, got_disp = convert_rgb(image), disparity_of(image)
    except BadRequestError:
        return "both_refuse" if isinstance(want, Exception) else \
            "port_only_refuses"
    if isinstance(want, Exception):
        return "pil_only_refuses"
    same = (got.shape == want.shape and np.array_equal(got, want)
            and got_disp.shape == want_disp.shape
            and np.array_equal(got_disp, want_disp, equal_nan=True))
    return "agree" if same else "differ"


def kind(name: str) -> str:
    for prefix, label in (("bmp", "BMP"), ("tiff", "TIFF"), ("gif", "GIF")):
        if name.startswith(prefix):
            return label
    return "PNM"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--files", type=int, default=6000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--show", type=int, default=20)
    args = parser.parse_args()
    warnings.simplefilter("ignore")
    variants = cases.all_variants()
    names = sorted(variants)
    counts = collections.defaultdict(collections.Counter)
    shown = []
    for i in range(args.files):
        rng = np.random.default_rng([args.seed, i])
        name = names[int(rng.integers(len(names)))]
        kinds = ("truncate", "flip") + (
            ("size", "type") if name.startswith("tiff") else ())
        damage = kinds[int(rng.integers(len(kinds)))]
        result = outcome(damaged(variants[name], rng, damage))
        counts[f"{kind(name)} {damage}"][result] += 1
        if result not in ("agree", "both_refuse") and len(shown) < args.show:
            shown.append(dict(variant=name, damage=damage, index=i,
                              outcome=result))
    total = collections.Counter()
    for c in counts.values():
        total.update(c)
    print(json.dumps(dict(files=args.files, seed=args.seed,
                          totals=dict(total),
                          by_kind={k: dict(v) for k, v in sorted(
                              counts.items())},
                          disagreements=shown)))
    return 0 if total["agree"] + total["both_refuse"] == args.files else 1


if __name__ == "__main__":
    sys.exit(main())
