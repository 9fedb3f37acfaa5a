"""PIL's reading of an image file, the reference the port's BMP, TIFF, GIF
and PNM/PFM decoders are held to (the JAX package reads images with PIL)."""

import io

import numpy as np
from PIL import Image


def pil_decode(data: bytes):
    """PIL's ``convert("RGB")`` of the bytes and the JAX stereo trainer's
    ground-truth array of them, or the exception PIL raises."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            rgb = np.asarray(im.convert("RGB"))
            is_uint16 = im.mode in ("I", "I;16", "I;16B", "I;16L")
            disp = np.asarray(im, np.float32)
    except Exception as exc:  # noqa: BLE001 - any refusal
        return exc, exc
    if disp.ndim == 3:
        disp = disp[..., 0]
    if is_uint16:
        disp = disp / 256.0
    return rgb, disp
