"""KITTI raw drives as Deep3D training data (port of
``stereo_tpu/train/kitti_dataset.py``).

Items are ``(left_full, left_down, right_full)`` float32 arrays in 0..1:
the full views padded 375x1242 -> 384x1280 and the left view resized to
96x320 (bilinear, antialiased), decoded by the port's native runtime.
``batch_iterator`` decodes on a background thread, shuffles and batches,
so host I/O overlaps the device's step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from .. import _native
from ..pipeline.camera.kitti import KITTI_PAD
from ..synthesis.right_view_synthesis import (RVS_DOWNSCALED_SHAPE,
                                              RVS_FULL_SHAPE)
from ..utils.image_io import (pad_image, read_image_chw,
                              read_kitti_drive_stereo_pairs)

Item = Tuple[np.ndarray, np.ndarray, np.ndarray]

__all__ = ["KittiStereoDataset", "batch_iterator", "RVS_FULL_SHAPE",
           "RVS_DOWNSCALED_SHAPE"]


class KittiStereoDataset:
    """Indexable dataset over one or more KITTI raw drives."""

    def __init__(self, drive_dirs: Sequence[str]):
        self._lefts: List[str] = []
        self._rights: List[str] = []
        for drive in drive_dirs:
            lefts, rights = read_kitti_drive_stereo_pairs(drive)
            self._lefts.extend(sorted(lefts))
            self._rights.extend(sorted(rights))
        if len(self._lefts) != len(self._rights):
            raise RuntimeError("Mismatched left/right image counts.")

    def __len__(self) -> int:
        return len(self._lefts)

    def __getitem__(self, idx: int) -> Item:
        raw_left = read_image_chw(self._lefts[idx])
        left = pad_image(raw_left, *KITTI_PAD) / 255.0
        left_down = _native.resize_bilinear_chw(raw_left,
                                                *RVS_DOWNSCALED_SHAPE) / 255.0
        right = pad_image(read_image_chw(self._rights[idx]), *KITTI_PAD) / 255.0
        return (left.astype(np.float32), left_down.astype(np.float32),
                right.astype(np.float32))


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True,
                   prefetch: int = 2) -> Iterator[Tuple[np.ndarray, ...]]:
    """Background-threaded shuffling batch loader: the order is
    ``np.random.default_rng(seed).shuffle`` of the indices, as in the JAX
    package; an item that fails to load raises here, in the consumer."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n_batches = (len(order) // batch_size if drop_last
                 else -(-len(order) // batch_size))
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    done = object()
    stop = threading.Event()

    def worker():
        try:
            for b in range(n_batches):
                if stop.is_set():
                    return
                idxs = order[b * batch_size:(b + 1) * batch_size]
                items = [dataset[int(i)] for i in idxs]
                q.put(tuple(np.stack(parts) for parts in zip(*items)))
        except Exception as exc:    # handed to the consumer, raised there
            q.put(exc)
        finally:
            q.put(done)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            # Bounded by one batch's loading: the worker always posts
            # `done` at its end, and an error before it.
            batch = q.get()
            if batch is done:
                return
            if isinstance(batch, Exception):
                raise batch
            yield batch
    finally:
        stop.set()
        while t.is_alive():          # unblock a worker waiting on put()
            try:                     # (it stops after the item it loads)
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        t.join()                     # it has ended: returns at once
