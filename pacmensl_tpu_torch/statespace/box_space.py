"""Dense bounding-box state space.

Counterpart of ``pacmensl_tpu/statespace/box_space.py`` (the reference
``StateSetConstrained``, ``src/StateSet/StateSetConstrained.cpp:132-221``,
rebuilt as a dense box): the state space is the bounding box of the
constraint set with a boolean validity mask = (constraints satisfied) AND
(reachable from the initial states).

* The reference's frontier BFS becomes a mask dilation on the device,
  ``mask |= shift(mask, s_r); mask &= constraint_ok``, iterated to a fixed
  point (:func:`bfs_closure`).
* ``State2Index`` becomes the C-order flat index into the box.
* Expansion embeds the old box in the new one with a zero pad.
* :attr:`BoxStateSpace.mask_is_constraint_only` records whether
  reachability pruned nothing, so the mask is the constraint test alone.

Box axes are allocated on a x1.5 capacity ladder (:func:`_ladder`), so most
expansion epochs keep the capacity and change only the mask.  The
reference package additionally water-fills a preallocated capacity and
builds masks in a device-build mode; those exist to avoid TPU recompiles
and are not ported (ROADMAP).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..sys.errors import StateSpaceError
from ..ops.stencil import shift_nd, coord_grid, box_shape_from_bounds
from .constraints import ConstraintSet

#: box elements evaluated per chunk when constraint scores are computed
#: over the whole box (bounds the [chunk, n_c] temporaries)
EVAL_CHUNK = 1 << 22

#: Hard cap on box capacity (elements): a runaway expansion fails with a
#: StateSpaceError instead of a device out-of-memory error.
MAX_BOX_ELEMS = int(3e8)


def bfs_closure(seed_mask: torch.Tensor, ok_mask: torch.Tensor,
                shifts: Sequence[Sequence[int]],
                max_iters: int) -> torch.Tensor:
    """Reachability closure of ``seed_mask`` under the reaction shifts,
    restricted to ``ok_mask`` (reference ``box_space.py:40-66``).  One
    host sync per dilation, to test for the fixed point."""
    mask = seed_mask & ok_mask
    for _ in range(max_iters):
        new = mask.clone()
        for s in shifts:
            new |= shift_nd(mask, s)
        new &= ok_mask
        if torch.equal(new, mask):
            break
        mask = new
    return mask


def _ladder(n: int) -> int:
    c = 4
    while c < n:
        c = max(c + 1, int(c * 3 / 2))
    return c


def _round_capacity(n: int, quantum: int = 1) -> int:
    c = _ladder(int(n))
    q = int(quantum)
    return -(-c // q) * q


def constraint_ok(constraints: ConstraintSet, shape, device,
                  offset=None, by_form=False) -> torch.Tensor:
    """Flat [n] bool: every constraint holds at box point x (+ ``offset``),
    evaluated in chunks on ``device``; the scores come from the constraint
    function, or with ``by_form`` from the constraints' form (what the
    synthesized-mask kernel evaluates)."""
    values = constraints.form_values if by_form else constraints.values
    n = int(np.prod(shape))
    b = constraints.bounds_tensor(device)
    out = torch.empty(n, dtype=torch.bool, device=device)
    off = (None if offset is None else
           torch.as_tensor(np.asarray(offset), dtype=torch.int64,
                           device=device))
    for lo in range(0, n, EVAL_CHUNK):
        hi = min(n, lo + EVAL_CHUNK)
        x = coord_grid(shape, device, lo, hi)
        if off is not None:
            x = x + off[None, :]
        out[lo:hi] = (values(x) <= b[None, :]).all(dim=1)
    return out


class BoxStateSpace:
    """Constraint-shaped state space on a dense bounding box.

    :attr:`shape` is a capacity: each axis is the bounding-box extent
    rounded up the ladder.  The validity mask excludes padded states, so
    padding never changes results; bound growth within capacity changes
    only the mask."""

    def __init__(self, stoichiometry, constraints: ConstraintSet,
                 init_states, device="cpu", pad_quanta=None):
        """``pad_quanta``: per-axis size quanta; each capacity axis is
        rounded up to a multiple of its quantum (a sharded solve makes
        axis 0 divisible by its rank count, reference
        ``box_space.py:122-162``)."""
        self.stoich = np.atleast_2d(np.asarray(stoichiometry, dtype=np.int64))
        self.constraints = constraints
        self.device = torch.device(device)
        self.pad_quanta = (np.ones(self.stoich.shape[1], np.int64)
                           if pad_quanta is None
                           else np.asarray(pad_quanta, np.int64).reshape(-1))
        self.init_states = np.atleast_2d(
            np.asarray(init_states, dtype=np.int64))
        if self.init_states.shape[1] != self.num_species:
            raise StateSpaceError(
                f"init states have {self.init_states.shape[1]} species, "
                f"stoichiometry has {self.num_species}")
        self._shape: Optional[Tuple[int, ...]] = None
        self._prev_mask: Optional[torch.Tensor] = None
        self._mask: Optional[torch.Tensor] = None
        self._mask_host: Optional[np.ndarray] = None
        self._mask_bytes: Optional[torch.Tensor] = None
        self._box_floor = np.zeros(self.num_species, np.int64)
        self.events = None
        self._build()

    # ------------------------------------------------------------ basics
    @property
    def num_species(self) -> int:
        return self.stoich.shape[1]

    @property
    def num_reactions(self) -> int:
        return self.stoich.shape[0]

    @property
    def num_constraints(self) -> int:
        return self.constraints.num_constraints

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def size(self) -> int:
        return int(np.prod(self._shape))

    @property
    def mask(self) -> torch.Tensor:
        """Validity mask over the box (bool, box-shaped, on the device)."""
        return self._mask

    @property
    def num_states(self) -> int:
        """Number of valid states (reference GetNumGlobalStates)."""
        return self._num_states

    @property
    def bounds(self) -> np.ndarray:
        return self.constraints.bounds

    # ------------------------------------------------------------- build
    def _build(self):
        """Build shape and mask, then verify face closure: no valid state
        on a capacity face may have a constraint-satisfying outward
        neighbor, or the box would truncate the true set.  Leaking axes
        grow and the build repeats."""
        for _ in range(64):
            self._build_once()
            if not self._leaks.any():
                return
            grown = np.asarray(self._shape, np.int64)  # face idx = shape-1
            self._box_floor = np.maximum(
                self._box_floor, np.where(self._leaks, (grown * 5) // 4 + 1,
                                          0))
        raise StateSpaceError(
            "box face closure did not converge: the constraint set appears "
            "unbounded along axes "
            f"{np.nonzero(self._leaks)[0].tolist()}")

    def _build_once(self):
        box_bounds = self.constraints.derive_box_bounds(
            self.num_species, self.init_states)
        box_bounds = np.maximum(box_bounds, self._box_floor)
        self._box_bounds = box_bounds
        raw_shape = np.asarray(box_shape_from_bounds(box_bounds))

        init_ok = self.constraints.all_satisfied(self.init_states)
        if not init_ok.all():
            raise StateSpaceError(
                "initial states violate the FSP constraints: "
                f"{self.init_states[~init_ok].tolist()}")
        if (self.init_states < 0).any() or \
                (self.init_states > box_bounds[None, :]).any():
            raise StateSpaceError("initial states outside the box")

        if self._shape is None or \
                any(int(s) > c for s, c in zip(raw_shape, self._shape)):
            new_shape = [max(_round_capacity(int(s), int(q)), c)
                         for s, c, q in zip(raw_shape, self._shape or
                                            (0,) * len(raw_shape),
                                            self.pad_quanta)]
            # The reference package snaps a minor extent in (94, 128] to 128
            # (a TPU lane group) instead of the ladder's 141; kept so both
            # packages run at the same capacity, whose size feeds the
            # Krylov cost model.
            if len(new_shape) >= 2 and int(raw_shape[-1]) <= 128 \
                    < int(new_shape[-1]) <= 141 \
                    and 128 % int(self.pad_quanta[-1]) == 0:
                new_shape[-1] = max(128, (self._shape or [0])[-1])
            new_shape = tuple(new_shape)
            new_size = int(np.prod(np.asarray(new_shape, np.float64)))
            if new_size > MAX_BOX_ELEMS:
                raise StateSpaceError(
                    f"FSP box capacity {new_shape} = {new_size:.3g} states "
                    f"exceeds the box-backend cap ({MAX_BOX_ELEMS:.3g}); "
                    "tighten the constraints")
            if self._prev_mask is not None:
                grown = torch.zeros(new_shape, dtype=torch.bool,
                                    device=self.device)
                grown[tuple(slice(0, o) for o in self._prev_mask.shape)] = \
                    self._prev_mask
                self._prev_mask = grown
            self._shape = new_shape

        t0 = time.perf_counter()
        shape = self._shape
        ok = constraint_ok(self.constraints, shape, self.device).reshape(shape)
        seed = (self._prev_mask.clone() if self._prev_mask is not None
                else torch.zeros(shape, dtype=torch.bool, device=self.device))
        seed.view(-1)[torch.as_tensor(
            np.ravel_multi_index(tuple(self.init_states.T), shape),
            device=self.device)] = True
        mask = bfs_closure(seed, ok, [tuple(int(v) for v in row)
                                      for row in self.stoich],
                           int(sum(shape)) + 1)
        self._leaks = self._face_leaks(mask)
        self._mask = mask
        self._mask_host = None
        self._mask_bytes = None
        self._num_states = int(mask.sum())
        # reachability pruned nothing: the mask is "every constraint
        # holds", which the box kernel can recompute from the bounds
        # instead of reading it (reference box_space.py:495-499)
        self.mask_is_constraint_only = self._num_states == int(ok.sum())
        if self.events is not None:
            self.events.add("MaskBFS", time.perf_counter() - t0)
        if not self._leaks.any():
            # only converged masks seed later builds
            self._prev_mask = mask

    def _face_leaks(self, mask: torch.Tensor) -> np.ndarray:
        """Per axis i: some valid state on the face x_i = shape_i - 1 has a
        growth move whose target satisfies every constraint."""
        shape = self._shape
        S = self.num_species
        leaks = np.zeros(S, dtype=bool)
        for i in range(S):
            grow_rs = [r for r in range(self.num_reactions)
                       if self.stoich[r, i] > 0]
            face = mask.select(i, shape[i] - 1)
            if not grow_rs or not bool(face.any()):
                continue
            fshape = tuple(e for d, e in enumerate(shape) if d != i)
            coords = coord_grid(fshape, self.device) if fshape else \
                torch.zeros((1, 0), dtype=torch.int64, device=self.device)
            x = torch.cat([coords[:, :i],
                           torch.full((coords.shape[0], 1), shape[i] - 1,
                                      dtype=torch.int64, device=self.device),
                           coords[:, i:]], dim=1)
            b = self.constraints.bounds_tensor(self.device)
            fm = face.reshape(-1)
            for r in grow_rs:
                tgt = x + torch.as_tensor(self.stoich[r], device=self.device)
                ok_t = (self.constraints.values(tgt) <= b[None, :]).all(1) \
                    & (tgt >= 0).all(1)
                if bool((fm & ok_t).any()):
                    leaks[i] = True
                    break
        return leaks

    # ------------------------------------------------------- expansion ---
    def set_bounds(self, new_bounds) -> None:
        """Grow constraint bounds and rebuild box and mask (reference
        SetShapeBounds + Expand)."""
        self.constraints = self.constraints.with_bounds(new_bounds)
        old_shape = self._shape
        self._build()
        if any(n < o for n, o in zip(self._shape, old_shape)):
            raise StateSpaceError("state space must not shrink on expansion")

    def embed_old(self, p_old: torch.Tensor,
                  old_shape: Tuple[int, ...]) -> torch.Tensor:
        """Zero-pad an old flat box vector into the current (larger) box
        (the ``ExpandVec`` analogue, PetscWrap.cpp:26-56); flat in, flat
        out.  Within capacity this is the identity."""
        old_shape = tuple(old_shape)
        if old_shape == tuple(self._shape):
            return p_old
        out = torch.zeros(self._shape, dtype=p_old.dtype,
                          device=p_old.device)
        out[tuple(slice(0, o) for o in old_shape)] = p_old.reshape(old_shape)
        return out.reshape(-1)

    # ---------------------------------------------------------- queries ---
    def mask_bytes(self) -> torch.Tensor:
        """The validity mask as flat uint8 on the device, the
        mask-reading kernel's input: one copy per mask, shared by every
        operator on the space."""
        if self._mask_bytes is None:
            self._mask_bytes = self._mask.reshape(-1).to(torch.uint8)
        return self._mask_bytes

    @property
    def mask_host(self) -> np.ndarray:
        """Host (numpy) copy of the validity mask."""
        if self._mask_host is None:
            self._mask_host = self._mask.cpu().numpy()
        return self._mask_host

    def states(self) -> np.ndarray:
        """Valid states [num_states, S] in C order (host)."""
        return torch.nonzero(self._mask).cpu().numpy().astype(np.int64)

    def state2index(self, states) -> np.ndarray:
        """Flat C-order box index of each state; -1 for states outside
        the box or invalid under the mask."""
        states = np.atleast_2d(np.asarray(states, dtype=np.int64))
        shape = np.asarray(self._shape, dtype=np.int64)
        strides = np.concatenate(
            [np.cumprod(shape[::-1])[::-1][1:], [1]])
        inside = ((states >= 0) & (states < shape[None, :])).all(axis=1)
        keys = states @ strides
        mask_flat = self.mask_host.reshape(-1)
        out = np.full(keys.shape, -1, dtype=np.int64)
        out[inside] = np.where(mask_flat[keys[inside]], keys[inside], -1)
        return out

    def extract_valid(self, p_flat: torch.Tensor) -> np.ndarray:
        """p at the valid states, in :meth:`states` order (host)."""
        return p_flat.reshape(-1)[self._mask.reshape(-1)].cpu().numpy()
