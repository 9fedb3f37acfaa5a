"""JAX's key-based random numbers (threefry2x32) in torch integer ops.

The port's explicit generator: a key is an int64 tensor of shape (..., 2)
holding two 32-bit words, and every function is pure (no global state).
It reproduces ``jax.random`` in its default partitionable mode
(``jax_threefry_partitionable=True``) bit for bit, so that a seed gives the
synthetic scenes the JAX package gives (``train/synthetic.py``):

* ``PRNGKey(seed)`` is ``(0, seed)`` for a seed in ``[0, 2**32)``;
* ``split(key, n)[i]`` and ``fold_in(key, i)`` are both
  ``threefry2x32(key, (0, i))``;
* ``random_bits(key, shape)[i]`` is ``x0 ^ x1`` of
  ``threefry2x32(key, (0, i))`` over the flat index ``i``;
* ``uniform`` puts the top 23 bits under the exponent of 1.0, subtracts
  1.0 and scales, then clamps at ``minval`` as ``jax.random.uniform`` does.

CUDA has few ``uint32`` ops, so the words live in int64 masked to 32 bits;
the functions run on whatever device their key lies on, and keys may carry
leading batch dimensions (the counterpart of ``vmap``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the count pairs ``(x0, x1)``,
    both of shape S, under each key of ``key`` (*B, 2) -> two (*B, *S)
    tensors of 32-bit words."""
    lead = (1,) * x0.dim()
    k0 = key[..., 0].reshape(key.shape[:-1] + lead)
    k1 = key[..., 1].reshape(key.shape[:-1] + lead)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    a = (x0 + ks[0]) & _MASK
    b = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return a, b


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key ``(0, seed)``."""
    seed = int(seed)
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def _counts(key: torch.Tensor, n: int) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=key.device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: key (*B, 2) -> (*B, num, 2)."""
    lo = _counts(key, num)
    a, b = threefry2x32(key, torch.zeros_like(lo), lo)
    return torch.stack([a, b], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with a data word in [0, 2**32): key (*B, 2)
    -> (*B, 2)."""
    d = torch.as_tensor(int(data) & _MASK, dtype=torch.int64,
                        device=key.device)
    a, b = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """32 random bits per element (``jax.random.bits`` for uint32), as
    int64 in [0, 2**32): key (*B, 2) -> (*B, *shape)."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    lo = _counts(key, n)
    a, b = threefry2x32(key, torch.zeros_like(lo), lo)
    return (a ^ b).reshape(key.shape[:-1] + shape)


def _as_f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def uniform(key: torch.Tensor, shape: Sequence[int] = (), minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: key (*B, 2) -> (*B, *shape).

    ``minval``/``maxval`` are numbers or float32 tensors that broadcast
    against the result (per-key bounds have shape (*B, 1, ...)).  The
    scale and shift are one fused multiply-add, as XLA fuses them on the
    CPU (``fma32``)."""
    bits = random_bits(key, shape)
    mantissa = (bits >> 9) | 0x3F800000
    floats = mantissa.to(torch.int32).view(torch.float32) - 1.0
    lo = _as_f32(minval, key.device)
    hi = _as_f32(maxval, key.device)
    scaled = fma32(floats, hi - lo, lo)
    return torch.maximum(lo, scaled)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors as a fused multiply-add: the
    product of two float32 numbers is exact in float64, so the float64 sum
    rounded to float32 is the FMA's result (but for a double-rounding tie,
    about once in 2^29)."""
    return (a.double() * b.double() + c.double()).float()


__all__ = ["PRNGKey", "fma32", "fold_in", "random_bits", "split",
           "threefry2x32", "uniform"]
