"""Stationary-distribution FSP solver.

Counterpart of ``pacmensl_tpu/stationary/solver.py`` (the reference's
``src/StationaryFsp/``: ``StationaryMCSolver`` and
``StationaryFspSolverMultiSinks``) on both backends, in float64:

* the singular stationary system ``A pi = 0`` is completed to the
  nonsingular ``(A + (2/n) d q^T) pi = d`` (d = diag(A), q = ones, n the
  state count) and solved by matrix-free GMRES from a nonzero initial
  guess, then normalized (``StationaryMCSolver.cpp:29-31, 58-89``);
* the outflow sinks of that solution are evaluated; where one exceeds the
  tolerance its constraint grows, the space expands, the solution is
  scattered into it as the next guess, and the solve repeats
  (``StationaryFspSolverMultiSinks.cpp:125-199``).

GMRES runs Jacobi-LEFT-preconditioned, as in the reference package, with
60 Krylov vectors per cycle (:data:`GMRES_RESTART`; the reference's 30
stagnate past about 100k states): the system solved is ``D^{-1} (A + (2/n) d q^T) x = 1_valid`` (D = diag(A)),
whose Krylov vectors and right-hand side have O(1) entries however far
the generator's diagonal spreads.  ``gmres_tol`` is relative in that
preconditioned norm; the unpreconditioned residual ``||A_mod x - d||`` of
each solve is kept in ``last_raw_res_norm_``.  The reference package's
64 eps floor on the tolerance (a float32 workaround) does not apply in
float64, nor its double-float engine: ``precision="df64"`` is the native
float64 solve.

Time-varying models are rejected: stationarity needs a time-invariant
generator.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple

import numpy as np
import torch

from ..sys.errors import IntegratorError, SetupError
from ..sys.events import EVT_ODESOLVE, EVT_TOTAL
from ..ops.gmres import gmres
from ..ops.vecops import FspVector, to_host
from ..fsp.solver import FspSolverMultiSinks
from ..fsp.distribution import DiscreteDistribution


#: Krylov vectors per GMRES cycle.  The reference package's 30 stall on
#: the repressilator at 104,440 states in float64 (preconditioned residual
#: 9.88 after 200 cycles, on the host): the TPU's "float32 wall" at
#: 96,142 states was this stagnation.  60 converge there (6,416 matvecs).
GMRES_RESTART = 60


class StationaryRound(NamedTuple):
    """One GMRES solve of the expansion loop."""
    backend: str           # "box" or "ell" (a box solve may migrate)
    num_states: int
    res_norm: float        # preconditioned, relative to ||1_valid||
    raw_res_norm: float    # ||A_mod x - d||
    n_matvecs: int
    sinks: np.ndarray
    seconds: float


class StationaryFspSolverMultiSinks(FspSolverMultiSinks):
    """Stationary CME distribution with adaptive FSP truncation."""

    def __init__(self, backend: str = "auto", gmres_tol: float = 1.0e-12,
                 precision: str = "native", **kw):
        if precision not in ("native", "df64"):
            raise SetupError(f"unknown precision {precision!r} (native or "
                             "df64, both float64)")
        super().__init__(backend=backend, **kw)
        self.gmres_tol = float(gmres_tol)
        self.precision = precision
        #: unpreconditioned ||A_mod x - d|| of the most recent solve
        self.last_raw_res_norm_ = float("nan")
        #: every GMRES solve of the last :meth:`solve`
        self.rounds_: List[StationaryRound] = []

    def set_model(self, model) -> "StationaryFspSolverMultiSinks":
        if model.tv_reactions:
            raise SetupError(
                "stationary FSP requires a time-invariant model")
        return super().set_model(model)

    def _stationary_solve(self, p_guess: torch.Tensor):
        """One rank-one-completed GMRES solve from ``p_guess``; returns
        (pi normalized, its sinks, the GMRES result, the raw residual)."""
        op = self._operator
        n_c = self.constraints.num_constraints
        diag = op.diagonal(0.0)
        # invalid and padding entries have no outflow: scale 1, rhs 0, so
        # they stay 0 in the Krylov space
        valid = diag.abs() > 1e-30
        safe_d = torch.where(valid, diag, torch.ones_like(diag))
        none = diag.new_zeros(0)
        b = FspVector(p=valid.to(diag.dtype), sinks=none)
        zero_sinks = diag.new_zeros(n_c)
        scale = 2.0 / float(self.num_states)

        def modified(v: FspVector) -> FspVector:
            av = op.action(0.0, FspVector(p=v.p, sinks=zero_sinks)).p
            return FspVector(p=(av + (v.p.sum() * scale) * diag) / safe_d,
                             sinks=none)

        res = gmres(modified, b, FspVector(p=p_guess, sinks=none),
                    restart=GMRES_RESTART, tol=self.gmres_tol,
                    atol=1e-300, max_restarts=200)
        raw = float(torch.linalg.vector_norm(
            (modified(res.x).p - b.p) * safe_d))
        pi = res.x.p / res.x.p.sum()
        sinks = op.action(0.0, FspVector(p=pi, sinks=zero_sinks)).sinks
        return pi, sinks, res, raw

    def solve(self, sfsp_tol: float = 1.0e-6, *_args,
              **_kw) -> DiscreteDistribution:
        """Reference StationaryFspSolverMultiSinks::Solve(sfsp_tol)."""
        if not self._set_up:
            self.set_up()
        y = self._initial_vector()
        p = y.p
        self.rounds_ = []
        with self._logging(), self.events.timed(EVT_TOTAL):
            while True:
                t0 = time.perf_counter()
                with self.events.timed(EVT_ODESOLVE):
                    pi, sinks, res, raw = self._stationary_solve(p)
                self.last_raw_res_norm_ = raw
                self.sinks_ = to_host(sinks, "EpochSinks")
                self.rounds_.append(StationaryRound(
                    self._backend_used, self.num_states, res.res_norm, raw,
                    res.n_matvecs,
                    self.sinks_.copy(), time.perf_counter() - t0))
                if not res.converged:
                    raise IntegratorError(
                        f"stationary GMRES stalled at {self.num_states} "
                        f"states (preconditioned residual "
                        f"{res.res_norm:.2e}, unpreconditioned {raw:.2e})")
                to_expand = self.sinks_ > sfsp_tol
                if not to_expand.any():
                    break
                if self.verbosity:
                    print(f"[stationary] sinks {self.sinks_} > {sfsp_tol}; "
                          "expanding")
                self._y = FspVector(p=pi, sinks=torch.zeros_like(y.sinks))
                self._expand(to_expand)
                p = self._y.p
            self._y = FspVector(p=pi, sinks=sinks)
            self._t_now = float("inf")
            d = self._make_distribution()
        d.t = float("nan")      # stationary: no time point
        return d

    Solve = solve
