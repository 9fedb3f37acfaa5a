"""What the port's video tests share: seeded drive-like frames made with
numpy, PSNR, and OpenCV (the JAX package's writer, and the decoder both
packages' files are held to).  ``cv2`` is imported inside the functions:
the port never imports it."""

import numpy as np


def psnr(a, b) -> float:
    """Peak signal-to-noise ratio of two uint8 arrays, in dB."""
    err = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if err == 0 else float(10 * np.log10(255.0 ** 2 / err))


def drive_frames(seed: int, n: int, height: int, width: int,
                 speed: float = 3.0) -> np.ndarray:
    """(n, height, width, 3) uint8 RGB frames of a seeded drive: textured
    rectangles over a shaded background, each moving ``speed`` pixels a
    frame at its own depth, with a little sensor noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:height, :width].astype(np.float64)
    base = rng.uniform(60, 190, 3)
    slope = rng.uniform(-60, 60, (2, 3))
    rects = [dict(y=rng.uniform(-height / 4, height), x=rng.uniform(
                      -width / 4, width), h=rng.uniform(height / 6, height / 2),
                  w=rng.uniform(width / 8, width / 3),
                  colour=rng.uniform(30, 225, 3),
                  freq=rng.uniform(0.05, 0.6, 2),
                  phase=rng.uniform(0, 2 * np.pi), depth=rng.uniform(0.3, 1.5))
             for _ in range(6)]
    frames = np.empty((n, height, width, 3), np.uint8)
    for t in range(n):
        img = (base + slope[0] * (yy / height)[..., None]
               + slope[1] * (xx / width)[..., None])
        for r in rects:
            x0 = r["x"] + speed * r["depth"] * t
            mask = ((yy >= r["y"]) & (yy < r["y"] + r["h"]) & (xx >= x0)
                    & (xx < x0 + r["w"]))
            tex = 35 * np.sin(r["freq"][0] * (xx - x0) + r["phase"]) * np.cos(
                r["freq"][1] * yy)
            img[mask] = r["colour"] + tex[mask][:, None]
        img += rng.normal(0, 2.0, img.shape)
        frames[t] = np.clip(np.round(img), 0, 255).astype(np.uint8)
    return frames


def cv2_read(path: str):
    """Every frame of a video as OpenCV decodes it, (T, H, W, 3) uint8
    RGB, and what OpenCV reports of it: fourcc, width, height, frame count
    and fps."""
    import cv2

    cap = cv2.VideoCapture(path)
    assert cap.isOpened(), path
    info = dict(
        fourcc=int(cap.get(cv2.CAP_PROP_FOURCC)).to_bytes(4, "little"),
        width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        frames=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        fps=cap.get(cv2.CAP_PROP_FPS))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[:, :, ::-1])
    cap.release()
    return np.stack(frames), info


def quality(decoded, source) -> dict:
    """Mean and worst PSNR of decoded frames against their sources (the
    sources cropped to the decoded size, as OpenCV crops odd sizes)."""
    h, w = decoded.shape[1:3]
    values = [psnr(d, s[:h, :w]) for d, s in zip(decoded, source)]
    return dict(mean=float(np.mean(values)), worst=float(np.min(values)))
