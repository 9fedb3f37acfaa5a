"""Pack an npz checkpoint into a smaller file and unpack it, bit for bit.

The committed checkpoints (``data/checkpoints``) store their weights in
float16, which the npz's own compression shrinks by about 7%.  Here each
array's bytes are regrouped by significance (every element's high byte,
which holds the sign and exponent, then every low byte) before LZMA
compresses them, which shrinks float16 weights by about 15%: enough to
send Deep3D's 256 MiB checkpoint through a copy limited to 256 MiB.
``unpack`` writes the arrays back as an uncompressed npz that ``np.load``
reads as the original: the same keys, dtypes, shapes and bytes.

    python -m stereo_tpu_torch.utils.npz_pack pack SRC.npz DST.pack
    python -m stereo_tpu_torch.utils.npz_pack unpack SRC.pack DST.npz
"""

from __future__ import annotations

import argparse
import json
import lzma
from typing import Dict

import numpy as np


def _planes(a: np.ndarray) -> bytes:
    """The array's bytes, most significant byte of every element first."""
    b = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    b = b.reshape(-1, a.dtype.itemsize)
    order = slice(None, None, -1) if a.dtype.byteorder != ">" else slice(None)
    return b[:, order].T.tobytes()


def _from_planes(data: bytes, dtype: np.dtype, shape) -> np.ndarray:
    planes = np.frombuffer(data, np.uint8).reshape(dtype.itemsize, -1)
    order = slice(None, None, -1) if dtype.byteorder != ">" else slice(None)
    return np.ascontiguousarray(planes.T[:, order]).view(dtype).reshape(shape)


def pack(src: str, dst: str) -> None:
    """Write the arrays of the npz ``src`` to ``dst``: a little-endian
    8-byte length, a JSON header (each key, dtype, shape and compressed
    size) and each array's compressed planes in header order."""
    header, blobs = [], []
    with np.load(src) as data:
        for key in data.files:
            a = data[key]
            blob = lzma.compress(_planes(a))
            header.append(dict(key=key, dtype=a.dtype.str, shape=a.shape,
                               size=len(blob)))
            blobs.append(blob)
    text = json.dumps(header).encode()
    with open(dst, "wb") as f:
        f.write(len(text).to_bytes(8, "little"))
        f.write(text)
        for blob in blobs:
            f.write(blob)


def load_packed(src: str) -> Dict[str, np.ndarray]:
    """The arrays of a file written by :func:`pack`, by key."""
    arrays = {}
    with open(src, "rb") as f:
        header = json.loads(f.read(int.from_bytes(f.read(8), "little")))
        for entry in header:
            data = lzma.decompress(f.read(entry["size"]))
            arrays[entry["key"]] = _from_planes(
                data, np.dtype(entry["dtype"]), tuple(entry["shape"]))
    return arrays


def unpack(src: str, dst: str) -> None:
    """Write the arrays of the packed file ``src`` as the npz ``dst``."""
    np.savez(dst, **load_packed(src))


def _main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Pack an npz checkpoint into a smaller file, or unpack "
                    "it into an npz, bit for bit.")
    parser.add_argument("action", choices=("pack", "unpack"))
    parser.add_argument("src")
    parser.add_argument("dst")
    args = parser.parse_args(argv)
    (pack if args.action == "pack" else unpack)(args.src, args.dst)


if __name__ == "__main__":
    _main()
