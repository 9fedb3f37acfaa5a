"""Models of the port, their registry and the loader of the committed
Flax checkpoints (port of ``stereo_tpu/models/__init__.py``)."""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .cost_volumes import (build_concat_volume, build_gwc_volume,
                           build_interlaced_volume, disparity_regression,
                           groupwise_correlation, upsampled_soft_argmin)
from .deep3d import Deep3D
from .gwcnet import GwcNet
from .layers import BatchNorm, Conv, _PackedDeconv
from .msnet import MSNet2D, MSNet3D

_NPZ_META_PREFIX = "__meta__"

_STEREO_MODELS = {"gwcnet": GwcNet, "msnet2d": MSNet2D, "msnet3d": MSNet3D}


def build_stereo_model(name: str, max_disparity: int = 192) -> nn.Module:
    """Construct a stereo network by registry name."""
    try:
        cls = _STEREO_MODELS[name]
    except KeyError:
        raise RuntimeError(f"Unknown stereo model {name!r}; "
                           f"available: {sorted(_STEREO_MODELS)}") from None
    return cls(max_disparity=max_disparity)


def _torch_kernel(module: str, t: torch.Tensor, key: str) -> torch.Tensor:
    """A Flax kernel in torch's layout: a Conv kernel (*k, I, O) becomes
    (O, I, *k), a Dense kernel (in, out) a Linear weight (out, in); a
    ConvTranspose kernel keeps the Flax layout the parity deconvolutions
    take."""
    if module.startswith("ConvTranspose_"):
        return t
    if module.startswith("Dense_"):
        return t.t()
    if t.dim() in (4, 5):
        return t.permute(t.dim() - 1, t.dim() - 2, *range(t.dim() - 2))
    raise ValueError(f"unexpected kernel {key!r}")


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
            t = _torch_kernel(module, t, key)
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


_FLAX_LEAVES = {("params", "kernel"): "weight", ("params", "bias"): "bias",
                ("params", "scale"): "weight",
                ("batch_stats", "mean"): "running_mean",
                ("batch_stats", "var"): "running_var"}


def stereo_state_dict_from_flax(arrays: Dict[str, np.ndarray]
                                ) -> Dict[str, torch.Tensor]:
    """Flax stereo-network variables, keyed as in the npz checkpoints
    (``"['params']['Hourglass3D_0']['ConvBnAct_0']['Conv_0']['kernel']"``,
    ``"['batch_stats'][...]['BatchNorm_0']['mean']"``), -> a float32
    ``state_dict`` of the port's network: BatchNorm ``scale``/``bias``
    become ``weight``/``bias`` and its ``mean``/``var`` the running
    statistics."""
    state = {}
    for key, arr in arrays.items():
        parts = re.findall(r"\['([^']+)'\]", key)
        if len(parts) < 3 or (parts[0], parts[-1]) not in _FLAX_LEAVES:
            raise ValueError(f"unexpected checkpoint key {key!r}")
        *path, leaf = parts[1:]
        t = torch.from_numpy(np.asarray(arr, np.float32))
        if leaf == "kernel":
            t = _torch_kernel(path[-1], t, key)
        state[".".join(path + [_FLAX_LEAVES[parts[0], leaf]])] = t.contiguous()
    return state


def load_stereo_npz(path: str) -> Dict[str, torch.Tensor]:
    """Read a stereo-network npz checkpoint (params stored as float16,
    batch statistics as float32) with numpy -> float32 ``state_dict``."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files
                  if not k.startswith(_NPZ_META_PREFIX)}
    return stereo_state_dict_from_flax(arrays)


def init_params(model: nn.Module, seed: int = 0) -> None:
    """Seeded random parameters from a ``torch.Generator``: convolution
    kernels normal with std fan_in^-1/2 (Flax's LeCun normal, untruncated),
    biases 0, BatchNorm scale 1 and statistics (0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (Conv, _PackedDeconv)):
                w = module.weight
                fan_in = (w[0].numel() if isinstance(module, Conv)
                          else w.numel() // w.shape[-1])
                w.copy_(torch.randn(w.shape, generator=gen) * fan_in ** -0.5)
                if getattr(module, "bias", None) is not None:
                    module.bias.zero_()
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)


def _check_shapes(model: nn.Module, state: Dict[str, torch.Tensor],
                  source: str) -> None:
    """Fail with an actionable message when a checkpoint's shapes do not
    fit this configuration (MSNet2D's parameters depend on its
    ``max_disparity``) instead of a bare size mismatch."""
    for key, want in model.state_dict().items():
        got = state.get(key)
        if got is not None and tuple(got.shape) != tuple(want.shape):
            raise ValueError(
                f"Checkpoint {source!r} does not fit this "
                f"{type(model).__name__}(max_disparity="
                f"{getattr(model, 'max_disparity', '?')}): parameter {key} "
                f"has shape {tuple(got.shape)}, expected {tuple(want.shape)}."
                f" Load it with the max_disparity it was trained with, or "
                f"pass state_dict/checkpoint_dir explicitly.")


def load_or_init_params(model: nn.Module, name: str,
                        checkpoint_dir: Optional[str] = None,
                        seed: int = 0) -> str:
    """Load trained parameters into ``model`` (``strict=True``) from the
    first npz found, ``checkpoint_dir`` (with or without ``.npz``) then the
    committed ``data/checkpoints/<name>.npz``; else a seeded init.  Returns
    the file used, or ``"seeded"``."""
    from ..utils.paths import model_checkpoint_dir

    for cand in (checkpoint_dir, model_checkpoint_dir(name)):
        if not cand:
            continue
        npz = cand if cand.endswith(".npz") else cand + ".npz"
        if os.path.isfile(npz):
            state = load_stereo_npz(npz)
            _check_shapes(model, state, npz)
            model.load_state_dict(state, strict=True)
            return npz
    init_params(model, seed)
    return "seeded"


__all__ = ["Deep3D", "GwcNet", "MSNet2D", "MSNet3D", "build_stereo_model",
           "deep3d_state_dict_from_flax", "load_deep3d_npz",
           "stereo_state_dict_from_flax", "load_stereo_npz", "init_params",
           "load_or_init_params", "build_concat_volume", "build_gwc_volume",
           "build_interlaced_volume", "disparity_regression",
           "groupwise_correlation", "upsampled_soft_argmin"]
