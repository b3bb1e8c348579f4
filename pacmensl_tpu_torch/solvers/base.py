"""Integrator layer: common contracts.

Counterpart of ``pacmensl_tpu/solvers/base.py`` (reference
``OdeSolverBase``, ``src/OdeSolver/OdeSolverBase.h``): an integrator
advances ``dy/dt = A(t) y`` from t0 toward t_final, calls an optional FSP
stop-check after every accepted step, and reports one of the status codes
0 (reached t_final) / 1 (FSP tolerance violated: the caller must expand the
state space) / -1 (fatal).

The port drives its step loops from the host.  The reference package
compiles each loop into one device program only to avoid round-trips to a
remote chip; on a local card the few host syncs per step are cheap.
"""
from __future__ import annotations

import enum
import inspect
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np

from ..ops.vecops import FspVector

#: matvec(t, y: FspVector) -> FspVector
MatVec = Callable[[Any, FspVector], FspVector]
#: stop_check(t, y[, aux]) -> per-constraint error excess [n_constraints]
#: (host numpy); any entry > 0 means FSP stop.  The solver records the
#: elementwise running max over every evaluation (SolveResult.viol_excess),
#: the reference's per-sink expansion flags (``to_expand_``,
#: FspSolverMultiSinks.cpp:576-611).  The optional third argument is the
#: ``stop_aux`` passed to ``solve``.
StopCheck = Callable[..., np.ndarray]


def wrap_stop_check(fn: Optional[StopCheck]) -> Optional[StopCheck]:
    """Normalize a stop-check to the 3-argument ``(t, y, aux)`` form."""
    if fn is None:
        return None
    try:
        n_params = len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        n_params = 2
    if n_params >= 3:
        return fn
    return lambda t, y, aux: fn(t, y)


class ODESolverType(enum.Enum):
    KRYLOV = "krylov"
    CVODE = "cvode"          # BDF + matrix-free GMRES
    PETSC = "petsc"          # adaptive explicit RK (Dormand-Prince 5(4))
    EPIC = "epic"            # alias of KRYLOV (reference: no backend)

    @classmethod
    def from_string(cls, s: str) -> "ODESolverType":
        s = s.strip().lower()
        for v in cls:
            if v.value == s or v.name.lower() == s:
                return v
        raise ValueError(f"unknown ODE solver type {s!r}")


class SolveStats(NamedTuple):
    n_steps: int       # accepted steps
    n_rejected: int
    n_matvecs: int


class StepRing:
    """Per-accepted-step trace in a fixed-capacity ring (reference
    per-step logging, ``OdeSolverBase.cpp:105-132``): entry
    ``i = step % capacity`` holds the step's end time, step size and a
    method-specific integer (the Krylov dimension m)."""

    def __init__(self, cap: int):
        self.t = np.zeros(cap)
        self.h = np.zeros(cap)
        self.aux = np.zeros(cap, dtype=np.int32)

    def record(self, n_steps: int, t: float, h: float, aux: int) -> None:
        i = n_steps % self.t.shape[0]
        self.t[i], self.h[i], self.aux[i] = t, h, aux

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.t, self.h, self.aux


class SolveResult(NamedTuple):
    y: FspVector
    t: float
    status: int               # 0 ok / 1 fsp stop / -1 failure
    stats: SolveStats
    viol_excess: np.ndarray   # [n_c] running max of stop-check excesses
    trace: Optional[StepRing] = None


# Status codes (reference OdeSolverBase.h:114).
STATUS_OK = 0
STATUS_FSP_STOP = 1
STATUS_FAILURE = -1
