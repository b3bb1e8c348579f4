"""Mixed-radix state indexing.

Counterpart of ``pacmensl_tpu/sys/indexing.py`` (the reference index math
of ``src/Sys/pacmenMath.h:33-213``): linearize N-dimensional non-negative
integer states into scalar keys (first species fastest, MATLAB-style),
invert the map, and deduplicate state rows by key.

Semantics match the reference:
  * key(x) = sum_i x_i * prod_{k<i} (nmax_k + 1)
  * a negative coordinate yields key -1
  * coordinate i exceeding nmax_i yields key -(i+2)

The numpy variants serve host-side assembly; :func:`sub2ind_torch` is the
tensor variant (any device).
"""
from __future__ import annotations

import numpy as np
import torch


def radix_strides(nmax) -> np.ndarray:
    """Strides of the mixed-radix system with per-digit maxima ``nmax``:
    ``strides[i] = prod_{k<i}(nmax[k]+1)``; first coordinate fastest."""
    nmax = np.asarray(nmax, dtype=np.int64)
    return np.concatenate([[1], np.cumprod(nmax[:-1] + 1)]).astype(np.int64)


def sub2ind(nmax, states) -> np.ndarray:
    """Linearize states (rows = states, columns = species) into int64 keys,
    with the reference's negative codes for out-of-range states
    (``pacmenMath.h:41-55``)."""
    nmax = np.asarray(nmax, dtype=np.int64)
    states = np.atleast_2d(np.asarray(states, dtype=np.int64))
    keys = states @ radix_strides(nmax)

    neg = (states < 0).any(axis=1)
    over_dim = np.where(states > nmax[None, :], 1, 0)
    first_over = np.argmax(over_dim, axis=1)
    any_over = over_dim.any(axis=1)

    keys = np.where(any_over, -(first_over + 2), keys)
    keys = np.where(neg, -1, keys)
    return keys


def ind2sub(nmax, keys) -> np.ndarray:
    """Invert :func:`sub2ind` for in-range keys. Returns [n, n_species]."""
    nmax = np.asarray(nmax, dtype=np.int64)
    keys = np.asarray(keys, dtype=np.int64)
    out = np.empty((keys.shape[0], nmax.shape[0]), dtype=np.int64)
    k = keys.copy()
    for i in range(nmax.shape[0]):
        base = nmax[i] + 1
        out[:, i] = k % base
        k //= base
    return out


def unique_states(states, nmax=None):
    """Deduplicate state rows; returns (unique_states, inverse_index), in
    order of first occurrence (reference ``unique_columns``)."""
    states = np.atleast_2d(np.asarray(states, dtype=np.int64))
    if nmax is None:
        nmax = states.max(axis=0, initial=0)
    keys = sub2ind(nmax, states)
    _, idx, inv = np.unique(keys, return_index=True, return_inverse=True)
    order = np.argsort(idx)
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    return states[np.sort(idx)], rank[inv]


def distribute_tasks(n_tasks: int, n_workers: int) -> np.ndarray:
    """Counts per worker for an equal-block split: the first
    ``n_tasks % n_workers`` workers get one extra task."""
    base = n_tasks // n_workers
    extra = n_tasks % n_workers
    return np.array([base + (1 if i < extra else 0) for i in range(n_workers)],
                    dtype=np.int64)


def get_task_range(n_tasks: int, n_workers: int, rank: int):
    """(start, end) of worker ``rank``'s block."""
    counts = distribute_tasks(n_tasks, n_workers)
    start = int(counts[:rank].sum())
    return start, start + int(counts[rank])


def sub2ind_torch(nmax, states: torch.Tensor) -> torch.Tensor:
    """Tensor variant of :func:`sub2ind` (out-of-range rows collapse to
    -1; only validity matters where it is used)."""
    nmax = torch.as_tensor(nmax, dtype=torch.int64, device=states.device)
    states = states.to(torch.int64)
    strides = torch.cat([torch.ones(1, dtype=torch.int64,
                                    device=states.device),
                         torch.cumprod(nmax[:-1] + 1, dim=0)])
    keys = states @ strides
    valid = ((states >= 0) & (states <= nmax[None, :])).all(dim=1)
    return torch.where(valid, keys, torch.full_like(keys, -1))
