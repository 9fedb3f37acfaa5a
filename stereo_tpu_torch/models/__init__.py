"""Models of the port and the loader of the committed Flax checkpoints."""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

from .deep3d import Deep3D

_NPZ_META_PREFIX = "__meta__"


def deep3d_state_dict_from_flax(arrays: Dict[str, np.ndarray]
                                ) -> Dict[str, torch.Tensor]:
    """Flax Deep3D parameters, keyed as in the npz checkpoints
    (``"['params']['DisparityEstimationNetwork_0']['VggBlock_0']['Conv_0']['kernel']"``),
    -> a ``Deep3D`` ``state_dict``.

    A conv kernel (H, W, I, O) becomes an (O, I, H, W) weight, a Dense
    kernel (in, out) a Linear weight (out, in); a ConvTranspose kernel keeps
    the Flax layout that ``Deconv2dParity`` takes.
    """
    state = {}
    for key, arr in arrays.items():
        parts = re.findall(r"\['([^']+)'\]", key)
        if not parts or parts[0] != "params":
            raise ValueError(f"unexpected checkpoint key {key!r}")
        *path, leaf = parts[1:]
        module = path[-1]
        t = torch.from_numpy(np.asarray(arr, np.float32))
        if leaf == "kernel":
            if module.startswith("ConvTranspose_"):
                pass
            elif module.startswith("Conv_"):
                t = t.permute(3, 2, 0, 1)
            elif module.startswith("Dense_"):
                t = t.t()
            else:
                raise ValueError(f"unexpected kernel {key!r}")
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise ValueError(f"unexpected checkpoint leaf {key!r}")
        state[".".join(path + [name])] = t.contiguous()
    return state


def load_deep3d_npz(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Read a Deep3D npz checkpoint (float16-stored) with numpy ->
    ``(state_dict in float32, meta)``; ``meta`` holds ``full_shape``,
    ``down_shape`` and ``prob_volume_scale`` where the file has them."""
    arrays, meta = {}, {}
    with np.load(path) as data:
        for key in data.files:
            if key.startswith(_NPZ_META_PREFIX):
                meta[key[len(_NPZ_META_PREFIX):]] = np.asarray(data[key])
            else:
                arrays[key] = data[key].astype(np.float32)
    return deep3d_state_dict_from_flax(arrays), meta


__all__ = ["Deep3D", "deep3d_state_dict_from_flax", "load_deep3d_npz"]
