"""Point-cloud construction and PLY export (a copy of
``stereo_tpu/utils/pointcloud.py``; the PLY bytes are the same).

Replaces the reference's open3d-based ``helpers/point_cloud_helpers.py:5-23``
with a dependency-free vectorized implementation: points are the pixel-grid
coordinates ``[y, x, depth]`` of every unmasked pixel (same convention as the
reference's double loop), written as binary little-endian PLY.
"""

from __future__ import annotations

import os

import numpy as np


def depth_to_points(depth_hw: np.ndarray, mask_hw: np.ndarray) -> np.ndarray:
    """(H, W) depth + boolean mask -> (N, 3) float64 points ``[y, x, z]``."""
    depth = np.asarray(depth_hw)
    mask = np.asarray(mask_hw, dtype=bool)
    xs, ys = np.nonzero(mask)                      # row (x), col (y) indices
    return np.stack([ys.astype(np.float64), xs.astype(np.float64),
                     depth[xs, ys].astype(np.float64)], axis=1)


def write_ply(points_n3: np.ndarray, filename: str) -> None:
    """Write an (N, 3) point array as binary_little_endian PLY."""
    pts = np.ascontiguousarray(np.asarray(points_n3, dtype=np.float64))
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {len(pts)}\n"
        "property double x\nproperty double y\nproperty double z\n"
        "end_header\n"
    )
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(pts.astype("<f8").tobytes())


def read_ply(filename: str) -> np.ndarray:
    """Read back a PLY written by :func:`write_ply` -> (N, 3) float64."""
    with open(filename, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        n = int([line for line in header.decode().splitlines()
                 if line.startswith("element vertex")][0].split()[-1])
        return np.frombuffer(f.read(n * 3 * 8), dtype="<f8").reshape(n, 3).copy()


def save_point_cloud_from_depth(depth_hw: np.ndarray, mask_hw: np.ndarray,
                                filename: str) -> None:
    """Parity with ``point_cloud_helpers.save_point_cloud_from_depth``."""
    write_ply(depth_to_points(depth_hw, mask_hw), filename)
