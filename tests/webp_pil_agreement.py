"""Holds the port's WebP decoder to PIL on thousands of seeded damaged files,
and counts every disagreement (not collected by pytest; PIL, the JAX
package's reader, is the reference)::

    python tests/webp_pil_agreement.py [--files 6000] [--seed 0] [--save DIR]

Each file is one of ``tests/test_torch_webp.py``'s cases (the files PIL
writes, the hand-built ALPH chunks and animations, the committed fixtures
from libwebp's encoder; the two full-width frames left out for time),
damaged by ``webp_files.damaged``: cut at a seeded length, one to four
seeded bytes replaced, the RIFF size or one chunk's size rewritten (to a
neighbour of the old size or to an edge of 32 bits), bytes of a VP8 frame
header or a VP8L header replaced, or the last chunk's payload cut short
with the sizes made to agree (the bitstream ends early). PIL either
decodes it (the port must give the same mode and samples) or refuses it
(the port must raise ``BadRequestError``). A file whose canvas is over
PIL's decompression-bomb limit (178956970 pixels) is counted apart and not
given to PIL: the port refuses it, PIL refuses it past twice the limit and
decodes it with a warning below, into a canvas of up to 1.4 GB. Prints one
JSON line: the files, the counts of each outcome by damage, and the first
disagreements (case, damage, seed and what differed); ``--save`` writes
each file of a disagreement there.
"""

import argparse
import collections
import io
import json
import os
import struct
import sys
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import test_torch_webp as cases  # noqa: E402
import webp_files as wf  # noqa: E402

from PIL import Image  # noqa: E402

from stereo_tpu_torch.utils.image_io import (  # noqa: E402
    BadRequestError, decode_image)

LIMIT = 178956970


def canvas_pixels(data: bytes) -> int:
    """The pixels of the canvas a VP8X chunk first in the file declares, 0
    for other files."""
    if len(data) >= 30 and data[12:16] == b"VP8X":
        w = 1 + int.from_bytes(data[24:27], "little")
        h = 1 + int.from_bytes(data[27:30], "little")
        return w * h
    return 0


def frame_pixels(data: bytes) -> int:
    """The pixels a simple file's VP8 or VP8L header declares, 0 for others."""
    if len(data) >= 30 and data[12:16] == b"VP8 ":
        return (int.from_bytes(data[26:28], "little") & 0x3fff) * (
            int.from_bytes(data[28:30], "little") & 0x3fff)
    if len(data) >= 25 and data[12:16] == b"VP8L":
        bits = struct.unpack("<I", data[21:25])[0]
        return ((bits & 0x3fff) + 1) * (((bits >> 14) & 0x3fff) + 1)
    return 0


def pil_open(data: bytes):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with Image.open(io.BytesIO(data)) as im:
                return im.mode, np.asarray(im)
    except Exception as exc:  # noqa: BLE001 - any refusal
        return exc


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--files", type=int, default=6000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--save", help="directory for the files that "
                        "disagree")
    args = parser.parse_args()
    pool = sorted(k for k in cases.CASES if not k.startswith(
        ("size_375", "size_128", "fixture_kitti")))
    rng = np.random.default_rng(args.seed)
    counts = collections.defaultdict(collections.Counter)
    disagreements = []
    for i in range(args.files):
        name = pool[int(rng.integers(len(pool)))]
        kind = wf.DAMAGE[int(rng.integers(len(wf.DAMAGE)))]
        data = wf.damaged(cases.all_cases()[name], rng, kind)
        try:
            got = decode_image(data)
        except BadRequestError as exc:
            got = exc
        if max(canvas_pixels(data), frame_pixels(data)) > LIMIT:
            outcome = ("over_limit_port_refuses"
                       if isinstance(got, BadRequestError)
                       else "over_limit_port_decodes")
            counts[kind][outcome] += 1
            if outcome == "over_limit_port_decodes":
                disagreements.append(dict(case=name, damage=kind, file=i,
                                          what=outcome))
            continue
        want = pil_open(data)
        pil_refuses = isinstance(want, Exception)
        port_refuses = isinstance(got, BadRequestError)
        if pil_refuses and port_refuses:
            outcome = "refused_by_both"
        elif pil_refuses:
            outcome = "pil_only_refuses"
        elif port_refuses:
            outcome = "port_only_refuses"
        elif got.mode == want[0] and np.array_equal(got.samples, want[1]):
            outcome = "equal"
        else:
            outcome = "differ"
        counts[kind][outcome] += 1
        if outcome not in ("equal", "refused_by_both"):
            what = (str(got) if port_refuses else
                    f"PIL: {type(want).__name__}: {want}" if pil_refuses
                    else f"mode {got.mode}/{want[0]}")
            disagreements.append(dict(case=name, damage=kind, file=i,
                                      what=what[:200]))
            if args.save:
                os.makedirs(args.save, exist_ok=True)
                with open(os.path.join(args.save, f"{i}.webp"), "wb") as f:
                    f.write(data)
    total = collections.Counter()
    for c in counts.values():
        total.update(c)
    print(json.dumps(dict(files=args.files, seed=args.seed,
                          total=dict(sorted(total.items())),
                          by_damage={k: dict(sorted(v.items()))
                                     for k, v in sorted(counts.items())},
                          disagreements=disagreements[:20])))


if __name__ == "__main__":
    main()
