"""FSP shape constraints.

Counterpart of ``pacmensl_tpu/statespace/constraints.py`` (the reference's
``StateSetConstrained``, ``src/StateSet/StateSetConstrained.h:35-68``): the
truncated state space is ``{x : f_i(x) <= b_i for all i}`` where ``f`` is a
batched torch function returning integer scores and ``b`` are integer
bounds.  The default constraint is coordinate-wise (``f_i(x) = x_i``).

``fn(states[n, S]) -> [n, n_constraints]`` runs on the device of its input:
host-side probes (the bounding-box search, initial-state checks) call it on
CPU tensors, the state-space builder and the operator on device tensors.

The CUDA box kernel cannot call Python, so a constraint set may also carry
a *device description* of its scores: one :class:`ConstraintForm` per
constraint, a small closed form the kernel evaluates in registers.  The
coordinate default has one automatically; a custom ``fn`` carries it as
the attribute ``fn.form`` next to ``fn.components``, and the set checks it
against ``fn`` when it is built.  A set without a form is evaluated by
``fn`` alone (the operator then uses the mask-reading kernel).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..sys.errors import StateSpaceError


class ConstraintForm(NamedTuple):
    """Closed form of one constraint score, evaluated in int64::

        f(x) = [x_g == v] * (sum_d w_d x_d + sum_k u_k x_{i_k} x_{j_k})

    ``weights`` holds ``(d, w_d)`` pairs, ``products`` ``(u_k, i_k, j_k)``
    triples, all integers; ``gate = (g, v)``, or None for no indicator."""
    weights: Tuple[Tuple[int, int], ...] = ()
    products: Tuple[Tuple[int, int, int], ...] = ()
    gate: Optional[Tuple[int, int]] = None

    @property
    def species(self) -> Tuple[int, ...]:
        """Every species index the form reads."""
        out = [d for d, _ in self.weights]
        for _, i, j in self.products:
            out += [i, j]
        if self.gate is not None:
            out.append(self.gate[0])
        return tuple(out)


def coord(d: int) -> ConstraintForm:
    """f(x) = x_d."""
    return ConstraintForm(weights=((int(d), 1),))


def linear(weights: dict) -> ConstraintForm:
    """f(x) = sum_d w_d x_d, from ``{d: w_d}``."""
    return ConstraintForm(weights=tuple(
        (int(d), int(w)) for d, w in sorted(weights.items())))


def product(i: int, j: int, u: int = 1) -> ConstraintForm:
    """f(x) = u x_i x_j."""
    return ConstraintForm(products=((int(u), int(i), int(j)),))


def gated(g: int, v: int, form: ConstraintForm) -> ConstraintForm:
    """f(x) = [x_g == v] * form(x)."""
    return form._replace(gate=(int(g), int(v)))


def form_values(forms: Sequence[ConstraintForm],
                states: torch.Tensor) -> torch.Tensor:
    """Scores of ``forms`` at ``states[n, S]``: [n, len(forms)] int64, on
    the device of ``states`` (the plain version of the kernel's
    evaluation)."""
    x = states.to(torch.int64)
    cols = []
    for f in forms:
        v = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        for d, w in f.weights:
            v = v + w * x[:, d]
        for u, i, j in f.products:
            v = v + u * x[:, i] * x[:, j]
        if f.gate is not None:
            g, gv = f.gate
            v = torch.where(x[:, g] == gv, v, torch.zeros_like(v))
        cols.append(v)
    return torch.stack(cols, dim=1)


#: seeded points on which a form is checked against its function, besides
#: the corners of the probe box
_FORM_CHECK_POINTS = 200


class ConstraintSet:
    """Bundle of (constraint function, RHS bounds, expansion factors)."""

    def __init__(self,
                 fn: Optional[Callable],
                 bounds,
                 expansion_factors=None,
                 num_species: Optional[int] = None,
                 box_cache: Optional[dict] = None):
        #: memo for derive_box_bounds, shared through with_bounds copies:
        #: an adaptive solve re-derives the bounding box of each epoch's
        #: bounds several times (routing check, space build, face-closure
        #: retries)
        self._box_cache = box_cache if box_cache is not None else {}
        self.fn = fn
        # Per-constraint component callables (each (states[n,S]) -> [n]):
        # coordinate getters for the default constraints, the ``components``
        # attribute of a custom fn where it carries one.
        if fn is None:
            nb = len(np.asarray(bounds).reshape(-1))
            self.components = tuple(
                (lambda x, _d=d: x[:, _d]) for d in range(nb))
            self.form = tuple(coord(d) for d in range(nb))
        else:
            comps = getattr(fn, "components", None)
            self.components = tuple(comps) if comps is not None else None
            form = getattr(fn, "form", None)
            self.form = tuple(form) if form is not None else None
        self.bounds = np.asarray(bounds, dtype=np.int64).reshape(-1)
        if expansion_factors is None:
            expansion_factors = np.full(self.bounds.shape, 0.25)
        self.expansion_factors = np.asarray(
            expansion_factors, dtype=np.float64).reshape(-1)
        if self.expansion_factors.shape != self.bounds.shape:
            raise StateSpaceError(
                "expansion_factors and bounds must have equal length "
                f"({self.expansion_factors.shape} vs {self.bounds.shape})")
        self.num_species = num_species
        if fn is None and num_species is not None and \
                len(self.bounds) != num_species:
            raise StateSpaceError(
                "default (coordinate-wise) constraints need one bound per "
                f"species: {len(self.bounds)} bounds, {num_species} species")
        if fn is not None and self.form is not None:
            self._check_form()

    @property
    def num_constraints(self) -> int:
        return self.bounds.shape[0]

    def values(self, states: torch.Tensor) -> torch.Tensor:
        """Constraint scores f(x): [n, n_constraints], on the device of
        ``states``."""
        if self.fn is None:
            return states  # coordinate-wise default
        vals = torch.as_tensor(self.fn(states))
        return vals.reshape(states.shape[0], self.num_constraints)

    def form_values(self, states: torch.Tensor) -> torch.Tensor:
        """Scores f(x) from the device description: [n, n_constraints]
        int64, on the device of ``states``."""
        if self.form is None:
            raise StateSpaceError("this constraint set has no form")
        return form_values(self.form, states)

    def _check_form(self) -> None:
        """Raise unless the form gives the function's scores on the
        corners of a box well beyond the bounds and on seeded points
        (including coordinates of -1, where a transition's target can
        lie).  Checked once per function and shared through
        :meth:`with_bounds` copies."""
        if len(self.form) != self.num_constraints:
            raise StateSpaceError(
                f"constraint form has {len(self.form)} entries for "
                f"{self.num_constraints} constraints")
        if "form_checked" in self._box_cache:
            return
        S = self.num_species
        if S is None:
            S = 1 + max((d for f in self.form for d in f.species),
                        default=0)
        hi = 2 * int(max(self.bounds.max(initial=0), 1)) + 2
        corners = np.array(np.meshgrid(*[[0, hi]] * S),
                           dtype=np.int64).reshape(S, -1).T
        rng = np.random.default_rng(0)
        pts = np.concatenate([
            corners,
            rng.integers(-1, hi + 1, size=(_FORM_CHECK_POINTS, S)),
            rng.integers(-1, 6, size=(_FORM_CHECK_POINTS, S))])
        x = torch.as_tensor(pts)
        want = torch.as_tensor(self.fn(x)).reshape(
            x.shape[0], self.num_constraints).to(torch.float64)
        got = form_values(self.form, x).to(torch.float64)
        bad = (want != got).any(dim=1)
        if bool(bad.any()):
            at = pts[int(torch.nonzero(bad)[0, 0])].tolist()
            raise StateSpaceError(
                "the constraint form disagrees with the constraint "
                f"function at {at}: form {got[bad][0].tolist()}, function "
                f"{want[bad][0].tolist()}")
        self._box_cache["form_checked"] = True

    def bounds_tensor(self, device) -> torch.Tensor:
        return torch.as_tensor(self.bounds, dtype=torch.int64, device=device)

    def satisfied(self, states) -> np.ndarray:
        """Per-constraint satisfaction bitmap [n, n_constraints] on the
        host (reference ``StateSetConstrained::CheckConstraints``,
        StateSetConstrained.cpp:63-82)."""
        st = torch.as_tensor(np.asarray(states, dtype=np.int64))
        return (self.values(st) <= self.bounds_tensor("cpu")[None, :]
                ).numpy()

    def all_satisfied(self, states) -> np.ndarray:
        return self._all_satisfied_with(states, self.bounds)

    def _all_satisfied_with(self, states, bounds) -> np.ndarray:
        st = torch.as_tensor(np.asarray(states, dtype=np.int64))
        b = torch.as_tensor(np.asarray(bounds, dtype=np.int64))
        return (self.values(st) <= b[None, :]).all(dim=1).numpy()

    def expanded_bounds(self, to_expand) -> np.ndarray:
        """Grow the flagged bounds by their expansion factors, with the
        reference's formula ``b <- round(b*(1+f) + 0.5)``
        (FspSolverMultiSinks.cpp:120-121)."""
        to_expand = np.asarray(to_expand, dtype=bool).reshape(-1)
        new_bounds = self.bounds.copy()
        grow = np.round(self.bounds * (self.expansion_factors + 1.0) + 0.5)
        new_bounds[to_expand] = grow[to_expand].astype(np.int64)
        return new_bounds

    def with_bounds(self, bounds) -> "ConstraintSet":
        return ConstraintSet(self.fn, bounds, self.expansion_factors,
                             self.num_species, box_cache=self._box_cache)

    def derive_box_bounds(self, num_species: int, init_states,
                          cap: int = 1 << 22) -> np.ndarray:
        """Per-species bounding box [b_0..b_{S-1}] of the constraint set.

        Default constraints: the box is the bounds.  Custom constraint
        functions: for each species, the largest coordinate v such that
        some witness state with ``x_i = v`` satisfies every constraint,
        with the other coordinates at every corner of {0, current box
        bound}; passes repeat until the box stops growing.  Assumes scores
        are non-decreasing in each coordinate at fixed others beyond the
        corner set; the box space verifies face closure after building.
        """
        init_arr = np.atleast_2d(np.asarray(init_states, dtype=np.int64))
        key = (num_species, self.bounds.tobytes(), init_arr.tobytes(), cap)
        if key in self._box_cache:
            return self._box_cache[key].copy()
        if self.fn is None:
            box = self.bounds.copy()
        else:
            box = self._probe_box(num_species, init_arr, cap)
        out = np.maximum(box, init_arr.max(axis=0))
        self._box_cache[key] = out.copy()
        return out

    def _probe_box(self, num_species: int, init_arr, cap: int) -> np.ndarray:
        """Corner-witness probe: one batched constraint evaluation per
        search round covers every species' witnesses, warm-started from
        the last box derived for this constraint function (the same grid
        search as the reference package, so both derive the same box)."""
        S = num_species
        lastkey = ("last", S, init_arr.tobytes(), cap)
        warm = self._box_cache.get(lastkey)
        box = np.zeros(S, dtype=np.int64)
        for _ in range(1 + S):
            prev = box.copy()
            blocks, spec_of = [], []
            for i in range(S):
                others = [d for d in range(S) if d != i]
                grid = np.array(
                    np.meshgrid(*[[0, int(box[d])] for d in others]),
                    dtype=np.int64).reshape(len(others), -1).T \
                    if others else np.zeros((1, 0), np.int64)
                corners = np.unique(grid, axis=0)
                w = np.zeros((corners.shape[0], S), np.int64)
                w[:, others] = corners
                blocks.append(w)
                spec_of.append(np.full(corners.shape[0], i))
            W = np.concatenate(blocks, axis=0)
            sp = np.concatenate(spec_of)
            n_rows = W.shape[0]
            rows = np.arange(n_rows)

            def feas_grid(cands):
                """cands: [S, K] candidate values -> feasible [S, K]."""
                K = cands.shape[1]
                Wk = np.broadcast_to(W, (K,) + W.shape).copy()
                Wk[:, rows, sp] = cands[sp, :].T
                ok = self._all_satisfied_with(
                    Wk.reshape(K * n_rows, S),
                    self.bounds).reshape(K, n_rows)
                out = np.zeros((S, K), dtype=bool)
                for i in range(S):
                    out[i] = ok[:, sp == i].any(axis=1)
                return out

            # Monotone grid search: lo = largest feasible value seen,
            # hi = smallest infeasible seen - 1; each round evaluates a
            # K-point grid in (lo, hi].
            K = 64
            lo = np.zeros(S, dtype=np.int64)
            hi = np.full(S, cap, dtype=np.int64)
            first = True
            for _round in range(10):
                act = lo < hi
                if not act.any():
                    break
                cands = np.zeros((S, K), dtype=np.int64)
                for i in range(S):
                    if not act[i]:
                        cands[i] = lo[i]
                        continue
                    if first:
                        # warm window + geometric ladder to the cap
                        w_i = (int(warm[i]) if warm is not None else 0)
                        win = np.linspace(max(w_i, 1),
                                          w_i + w_i // 4 + 2, 40)
                        geo = np.geomspace(1, cap, K - 40)
                        c = np.concatenate([win, geo])
                    else:
                        c = np.linspace(lo[i] + 1, hi[i], K)
                    cands[i] = np.clip(np.round(c).astype(np.int64),
                                       lo[i] + 1, hi[i])
                f = feas_grid(cands)
                for i in range(S):
                    if not act[i]:
                        continue
                    ci = cands[i]
                    if f[i].any():
                        lo[i] = max(lo[i], int(ci[f[i]].max()))
                    bad = ci[~f[i]]
                    bad = bad[bad > lo[i]]
                    if bad.size:
                        hi[i] = min(hi[i], int(bad.min()) - 1)
                    hi[i] = max(hi[i], lo[i])
                first = False
            box = lo
            if (box == prev).all():
                break
        self._box_cache[lastkey] = box.copy()
        return box
