"""Wrap-padded box sums (PyTorch port of ``stereo_tpu/ops/boxfilter.py``).

Border indices wrap mod the axis length (the reference's ``pad_index``).
Window sums are direct shifted adds in index order, the JAX op's order for
every radius the configs use (window <= 32), so integer-valued inputs give
bit-identical sums.
"""

from __future__ import annotations

import torch


def wrap_pad(x: torch.Tensor, radius: int, axis: int) -> torch.Tensor:
    """Circularly pad ``x`` by ``radius`` on both sides of ``axis``."""
    if radius == 0:
        return x
    n = x.shape[axis]
    idx = torch.arange(-radius, n + radius, device=x.device) % n
    return x.index_select(axis, idx)


def box_sum_1d(x: torch.Tensor, radius: int, axis: int,
               prepadded: bool = False) -> torch.Tensor:
    """Windowed sum over ``[i - radius, i + radius]`` along ``axis`` with
    wrap-around borders.  Output shape == input shape.  With ``prepadded``
    the input already carries ``radius`` more entries on each side of
    ``axis`` (a row shard extended by its neighbours' rows): nothing wraps,
    and the output is ``2 * radius`` shorter."""
    if radius == 0:
        return x
    if prepadded:
        xp, n = x, x.shape[axis] - 2 * radius
    else:
        xp, n = wrap_pad(x, radius, axis), x.shape[axis]
    acc = xp.narrow(axis, 0, n)
    for i in range(1, 2 * radius + 1):
        acc = acc + xp.narrow(axis, i, n)
    return acc


def box_sum_2d(x: torch.Tensor, radius_rows: int, radius_cols: int,
               row_axis: int = -2, col_axis: int = -1,
               rows_prepadded: bool = False) -> torch.Tensor:
    """Separable 2-D wrap box sum: columns first, then rows
    (``rows_prepadded``: see ``box_sum_1d``'s ``prepadded``)."""
    return box_sum_1d(box_sum_1d(x, radius_cols, col_axis), radius_rows,
                      row_axis, prepadded=rows_prepadded)
