"""The compressed state set (ELL backend).

Counterpart of ``pacmensl_tpu/statespace/state_set.py`` (reference
``StateSetBase`` / ``StateSetConstrained``, ``src/StateSet/
StateSetBase.cpp``, ``StateSetConstrained.cpp``): an explicit,
insertion-ordered list of states with

* ``add_states``  -- deduplicating insert (reference ``AddStates``,
  StateSetBase.cpp:188-258);
* ``state2index`` -- batch lookup of global indices, -1 for absent states
  (reference ``State2Index``, StateSetBase.cpp:309-343);
* ``expand``      -- frontier BFS closure under the reaction shifts,
  filtered by the constraints (reference ``Expand``,
  StateSetConstrained.cpp:132-221).

The state -> index map is the native hash directory
(:class:`~..native.fastset.FastSet`) on mixed-radix keys; ``use_native=
False`` takes its numpy plain version instead (tests).  Lookups happen at
assembly, once per expansion epoch, never in the integrator's loop, so the
directory lives on the host.  States are int64 numpy arrays; constraints
are evaluated by the port's :class:`~.constraints.ConstraintSet` on CPU
tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..native.fastset import FastSet, PlainSet, sub2ind_native
from ..sys import indexing
from ..sys.errors import StateSpaceError
from .constraints import ConstraintSet


class StateSet:
    """Insertion-ordered deduplicated set of integer states."""

    def __init__(self, stoichiometry, constraints: ConstraintSet,
                 init_states=None, use_native: bool = True):
        self.stoich = np.atleast_2d(np.asarray(stoichiometry, dtype=np.int64))
        self.constraints = constraints
        self.states = np.zeros((0, self.num_species), dtype=np.int64)
        self._use_native = bool(use_native)
        self._key_bounds = np.zeros(self.num_species, np.int64)
        self._refresh_key_space()
        self._dir = self._new_dir(1024)
        if init_states is not None:
            self.add_states(init_states)

    # ------------------------------------------------------------ basics
    @property
    def num_species(self) -> int:
        return self.stoich.shape[1]

    @property
    def num_reactions(self) -> int:
        return self.stoich.shape[0]

    @property
    def num_states(self) -> int:
        return self.states.shape[0]

    @property
    def num_constraints(self) -> int:
        return self.constraints.num_constraints

    def _new_dir(self, capacity_hint: int):
        return (FastSet if self._use_native else PlainSet)(capacity_hint)

    # --------------------------------------------------------- key space
    def _refresh_key_space(self) -> None:
        """Key bounds from the constraint box, padded by the stoichiometry
        range so members and their neighbours all have keys (the box probe
        can under-estimate gated constraints: :meth:`_ensure_key_space`
        grows the key space when an incoming state exceeds it)."""
        # the members' coordinate maxima stand for the members: the box
        # depends on them only through that row, and one row keeps the
        # probe's cache key small
        seed = (self.states.max(axis=0, keepdims=True) if self.states.size
                else np.zeros((1, self.num_species), dtype=np.int64))
        box = self.constraints.derive_box_bounds(self.num_species, seed)
        pad = np.abs(self.stoich).max(axis=0)
        self._key_bounds = self._checked_key_bounds(
            np.maximum(box + pad, self._key_bounds))

    @staticmethod
    def _checked_key_bounds(box) -> np.ndarray:
        if float(np.prod(np.asarray(box, np.float64) + 1.0)) >= 2.0 ** 62:
            raise StateSpaceError(
                "state key space exceeds int64; this constraint shape needs "
                f"a wider key type (box bounds: {list(box)!r})")
        return np.asarray(box, dtype=np.int64)

    def _ensure_key_space(self, states: np.ndarray) -> None:
        """Grow the key space (with a 25% margin) to cover ``states``: an
        out-of-range coordinate would get a negative key, which the
        directory rejects, and the state would be dropped silently."""
        mx = states.max(axis=0)
        if (mx <= self._key_bounds).all():
            return
        need = mx + np.abs(self.stoich).max(axis=0)
        self._key_bounds = self._checked_key_bounds(np.maximum(
            self._key_bounds, np.maximum(need, (need * 5) // 4 + 1)))
        self._reindex()

    def _keys_of(self, states) -> np.ndarray:
        if self._use_native:
            return sub2ind_native(self._key_bounds, states)
        return indexing.sub2ind(self._key_bounds, states)

    def _reindex(self) -> None:
        """Rebuild the directory: keys depend on the key bounds (the
        reference updates its Zoltan entries in place, StateSetBase.cpp:
        459-476; a rebuild is the same O(n) work)."""
        self._dir = self._new_dir(max(2 * self.num_states, 1024))
        if self.num_states:
            self._dir.insert(self._keys_of(self.states))

    # ------------------------------------------------------------ insert
    def add_states(self, new_states) -> int:
        """Insert states, deduplicated against the members and within the
        batch; states that violate a constraint or have a negative
        coordinate are dropped.  Returns the number added."""
        new_states = np.atleast_2d(np.asarray(new_states, dtype=np.int64))
        if new_states.shape[1] != self.num_species:
            raise StateSpaceError(
                f"states have {new_states.shape[1]} species, expected "
                f"{self.num_species}")
        ok = self.constraints.all_satisfied(new_states)
        ok &= (new_states >= 0).all(axis=1)
        new_states = new_states[ok]
        if new_states.size == 0:
            return 0
        self._ensure_key_space(new_states)
        fresh = self._dir.insert(self._keys_of(new_states))
        if not fresh.any():
            return 0
        self.states = np.concatenate([self.states, new_states[fresh]])
        return int(fresh.sum())

    # ------------------------------------------------------------ lookup
    def state2index(self, states) -> np.ndarray:
        """Global index of each state, or -1 where it is absent."""
        states = np.atleast_2d(np.asarray(states, dtype=np.int64))
        return self._dir.lookup(self._keys_of(states))

    # ------------------------------------------------------------ expand
    def expand(self, max_rounds: int = 1_000_000, old_bounds=None) -> int:
        """Frontier BFS closure: add x + s_r of every unexplored state that
        satisfies the constraints, until no frontier remains.  Returns the
        number of states added.

        ``old_bounds``: the bounds the set was last closed under.  Then
        the first frontier is only the members with a successor that
        violated the old bounds and satisfies the new ones: a state new
        under grown bounds is reachable only through such a transition,
        so the restricted seed is exact."""
        old_kb = self._key_bounds.copy()
        self._refresh_key_space()
        if not np.array_equal(old_kb, self._key_bounds):
            self._reindex()
        frontier = self.states
        if old_bounds is not None and self.num_states:
            old_b = np.asarray(old_bounds, dtype=np.int64).reshape(-1)
            new_b = self.constraints.bounds
            if old_b.shape == new_b.shape and (new_b >= old_b).all():
                seed = np.zeros(self.num_states, dtype=bool)
                for r in range(self.num_reactions):
                    tgt = self.states + self.stoich[r][None, :]
                    vals = self.constraints.values(
                        torch.as_tensor(tgt)).numpy()
                    was_out = (vals > old_b[None, :]).any(axis=1)
                    now_in = (vals <= new_b[None, :]).all(axis=1) \
                        & (tgt >= 0).all(axis=1)
                    seed |= was_out & now_in
                frontier = self.states[seed]
        added_total = 0
        for _ in range(max_rounds):
            if frontier.shape[0] == 0:
                break
            cands = (frontier[:, None, :] + self.stoich[None, :, :]
                     ).reshape(-1, self.num_species)
            n_before = self.num_states
            added_total += self.add_states(cands)
            frontier = self.states[n_before:]
        return added_total

    def set_bounds(self, new_bounds) -> None:
        self.constraints = self.constraints.with_bounds(new_bounds)

    def reorder(self, perm) -> None:
        """Put the states in a new global order (position = index), the
        counterpart of Zoltan migrating states between ranks
        (StatePartitionerBase.cpp:186-239)."""
        perm = np.asarray(perm, dtype=np.int64)
        if perm.shape[0] != self.num_states:
            raise StateSpaceError(
                f"permutation length {perm.shape[0]} != num_states "
                f"{self.num_states}")
        self.states = np.ascontiguousarray(self.states[perm])
        self._reindex()

    def copy_states(self) -> np.ndarray:
        """Reference CopyStatesOnProc."""
        return self.states.copy()
