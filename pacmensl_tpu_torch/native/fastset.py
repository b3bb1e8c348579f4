"""The state directory: mixed-radix state key -> insertion rank.

Counterpart of ``pacmensl_tpu/native/fastset.py`` (the reference's Zoltan
distributed directory, ``src/StateSet/StateSetBase.cpp:630``,
``Zoltan_DD_Update/Find`` at ``:209-234, 330``) in one address space.
Two implementations with one interface:

* :class:`FastSet`, the native open-addressing hash table of
  ``fastset.cpp`` (built at first use, see :mod:`.build`): the one the
  state set uses;
* :class:`PlainSet`, a numpy sorted-key binary search: the plain version
  the tests hold the native one against.

Keys are int64; negative keys (the invalid-state codes of
:func:`~..sys.indexing.sub2ind`) are never inserted and look up as -1.
"""
from __future__ import annotations

import ctypes

import numpy as np

from . import build

_P_I64 = ctypes.POINTER(ctypes.c_int64)
_P_U8 = ctypes.POINTER(ctypes.c_uint8)


def _as_i64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64)).reshape(-1)


class FastSet:
    """Insertion-ordered int64 key set, native: key -> insertion rank."""

    def __init__(self, capacity_hint: int = 1024):
        self._lib = build.load()
        self._h = self._lib.fastset_create(int(max(capacity_hint, 1)))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.fastset_destroy(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.fastset_size(self._h))

    def insert(self, keys) -> np.ndarray:
        """Insert keys; a bool mask of the newly added ones (the first
        occurrence within the batch wins)."""
        keys = _as_i64(keys)
        out = np.empty(keys.shape[0], dtype=np.uint8)
        self._lib.fastset_insert(self._h, keys.ctypes.data_as(_P_I64),
                                 keys.shape[0], out.ctypes.data_as(_P_U8))
        return out.astype(bool)

    def lookup(self, keys) -> np.ndarray:
        """Insertion rank of each key, or -1 if absent or invalid."""
        keys = _as_i64(keys)
        out = np.empty(keys.shape[0], dtype=np.int64)
        self._lib.fastset_lookup(self._h, keys.ctypes.data_as(_P_I64),
                                 keys.shape[0], out.ctypes.data_as(_P_I64))
        return out


class PlainSet:
    """The same directory as sorted keys and a binary search (numpy)."""

    def __init__(self, capacity_hint: int = 1024):
        self._n = 0
        self._sorted = np.zeros(0, np.int64)
        self._rank = np.zeros(0, np.int64)

    def __len__(self) -> int:
        return self._n

    def _find(self, keys: np.ndarray) -> np.ndarray:
        out = np.full(keys.shape[0], -1, dtype=np.int64)
        if self._sorted.size == 0:
            return out
        valid = keys >= 0
        pos = np.clip(np.searchsorted(self._sorted, keys[valid]), 0,
                      self._sorted.size - 1)
        hit = self._sorted[pos] == keys[valid]
        out[valid] = np.where(hit, self._rank[pos], -1)
        return out

    def insert(self, keys) -> np.ndarray:
        keys = _as_i64(keys)
        new = np.zeros(keys.shape[0], dtype=bool)
        valid = np.flatnonzero(keys >= 0)
        _, first = np.unique(keys[valid], return_index=True)
        new[valid[first]] = True
        new &= self._find(keys) < 0
        if new.any():
            fresh = keys[new]
            allk = np.concatenate([self._sorted, fresh])
            allr = np.concatenate(
                [self._rank, self._n + np.arange(fresh.shape[0])])
            order = np.argsort(allk, kind="stable")
            self._sorted, self._rank = allk[order], allr[order]
            self._n += fresh.shape[0]
        return new

    def lookup(self, keys) -> np.ndarray:
        return self._find(_as_i64(keys))


def sub2ind_native(nmax, states) -> np.ndarray:
    """Mixed-radix keys of ``states`` [n, S] (the semantics of
    :func:`~..sys.indexing.sub2ind`) computed by the native library."""
    lib = build.load()
    nmax = _as_i64(nmax)
    states = np.ascontiguousarray(
        np.atleast_2d(np.asarray(states, dtype=np.int64)))
    n, dim = states.shape
    out = np.empty(n, dtype=np.int64)
    lib.fastset_sub2ind(nmax.ctypes.data_as(_P_I64), dim,
                        states.ctypes.data_as(_P_I64), n,
                        out.ctypes.data_as(_P_I64))
    return out
