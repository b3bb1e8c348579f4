"""Stencil primitives for the dense-box backend.

Counterpart of ``pacmensl_tpu/ops/stencil.py``.  The probability vector is
a dense N-d array over the state bounding box, so the CME move
``x -> x + s_r`` becomes a zero-filled array shift.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def shift_nd(a: torch.Tensor, shifts: Sequence[int]) -> torch.Tensor:
    """Shift ``a`` by ``shifts`` with zero fill: out[i] = a[i - s] where
    ``i - s`` lies in the box, else 0."""
    shifts = tuple(int(s) for s in shifts)
    if all(s == 0 for s in shifts):
        return a
    out = torch.zeros_like(a)
    if any(abs(s) >= n for s, n in zip(shifts, a.shape)):
        return out
    dst = tuple(slice(max(s, 0), n + min(s, 0))
                for s, n in zip(shifts, a.shape))
    src = tuple(slice(max(-s, 0), n - max(s, 0))
                for s, n in zip(shifts, a.shape))
    out[dst] = a[src]
    return out


def coord_grid(shape: Tuple[int, ...], device="cpu", start: int = 0,
               stop=None, origin0: int = 0) -> torch.Tensor:
    """Coordinates of the box's flat C-order indices ``[start, stop)``:
    [stop - start, ndim] int64 (the whole box by default), axis 0 offset
    by ``origin0`` (a window of axis-0 planes of a larger box)."""
    n = int(np.prod(shape))
    stop = n if stop is None else int(stop)
    idx = torch.arange(int(start), stop, dtype=torch.int64, device=device)
    cols = []
    for d in range(len(shape) - 1, 0, -1):
        cols.append(idx % int(shape[d]))
        idx = idx // int(shape[d])
    cols.append(idx + int(origin0))
    return torch.stack(cols[::-1], dim=1)


def box_shape_from_bounds(box_bounds) -> Tuple[int, ...]:
    """Array shape for per-species coordinate maxima (inclusive)."""
    return tuple(int(b) + 1 for b in np.asarray(box_bounds).reshape(-1))
