"""KITTI calibration parsing and Velodyne -> image-plane depth projection
(a copy of ``stereo_tpu/utils/velodyne.py``; NumPy only).

Functional equivalent of the reference's ``helpers/velodyne_points_helpers.py``
(itself derived from monodepth's evaluation utils), re-implemented fully
vectorized: duplicate image-plane hits are resolved with a single
``np.minimum.at`` scatter instead of a Python ``Counter`` loop.

The projection math is fixed by the KITTI calibration format:
``P_velo2im = P_rect_0c @ R_rect_00 @ Tr_velo_to_cam``.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np


def read_calib_file(path: str) -> Dict[str, np.ndarray]:
    """Parse a KITTI ``key: v0 v1 ...`` calibration file; numeric values
    become float arrays, everything else stays a string."""
    data: Dict[str, np.ndarray] = {}
    with open(path, "r") as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            value = value.strip()
            try:
                data[key] = np.array([float(v) for v in value.split()])
            except ValueError:
                data[key] = value  # type: ignore[assignment]
    return data


def get_focal_length_baseline(calib_dir: str, cam: int = 2) -> Tuple[float, float]:
    """Left-color-camera focal length (px) and stereo baseline (m) from
    ``calib_cam_to_cam.txt`` (parity: ``velodyne_points_helpers.py:9-20``)."""
    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    p2 = cam2cam["P_rect_02"].reshape(3, 4)
    p3 = cam2cam["P_rect_03"].reshape(3, 4)
    baseline = (p3[0, 3] / -p3[0, 0]) - (p2[0, 3] / -p2[0, 0])
    focal = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)[0, 0]
    return float(focal), float(baseline)


def load_velodyne_points(path: str) -> np.ndarray:
    """Raw ``.bin`` scan -> (N, 4) homogeneous points (reflectance -> 1)."""
    points = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    points[:, 3] = 1.0
    return points


def velodyne_to_image_projection(calib_dir: str, cam: int = 2) -> np.ndarray:
    """(3, 4) projection matrix from velodyne frame to camera ``cam``'s
    rectified image plane."""
    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam_raw = read_calib_file(os.path.join(calib_dir, "calib_velo_to_cam.txt"))
    velo2cam = np.eye(4)
    velo2cam[:3, :3] = velo2cam_raw["R"].reshape(3, 3)
    velo2cam[:3, 3] = velo2cam_raw["T"]
    r_rect = np.eye(4)
    r_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    p_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    return p_rect @ r_rect @ velo2cam


def generate_depth_map(calib_dir: str, velo_file_name: str,
                       im_shape: Tuple[int, int], cam: int = 2,
                       vel_depth: bool = False) -> np.ndarray:
    """Sparse (H, W) depth map from one Velodyne scan.

    Matches the reference/monodepth algorithm exactly, including the
    ``round(u) - 1`` KITTI-matlab pixel convention and min-depth resolution
    of duplicate hits, but vectorized.
    """
    proj = velodyne_to_image_projection(calib_dir, cam)
    velo = load_velodyne_points(velo_file_name)
    velo = velo[velo[:, 0] >= 0]

    pts = (proj @ velo.T).T                       # (N, 3): [u*z, v*z, z]
    pts[:, :2] /= pts[:, 2:3]
    if vel_depth:
        pts[:, 2] = velo[:, 0]                    # forward distance, not z

    u = np.round(pts[:, 0]) - 1
    v = np.round(pts[:, 1]) - 1
    valid = (u >= 0) & (v >= 0) & (u < im_shape[1]) & (v < im_shape[0])
    u = u[valid].astype(np.int64)
    v = v[valid].astype(np.int64)
    z = pts[valid, 2]

    depth = np.full(im_shape, np.inf)
    np.minimum.at(depth, (v, u), z)               # closest point wins
    depth[np.isinf(depth)] = 0.0
    depth[depth < 0] = 0.0
    return depth
