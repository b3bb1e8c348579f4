"""Error handling for pacmensl_tpu.

The reference library propagates integer return codes through every layer and
aborts at ``main`` (``src/Sys/ErrorHandling.h:32-124``).  In Python the
idiomatic equivalent is a small exception hierarchy; we additionally keep the
integer status codes used by the ODE-solver layer, because the FSP driver
dispatches on them (0 = reached t_final, 1 = FSP tolerance violated,
-1 = fatal; see reference ``src/OdeSolver/OdeSolverBase.h:114``).
"""
from __future__ import annotations


class PacmenslError(RuntimeError):
    """Base class for all pacmensl_tpu errors."""


class SetupError(PacmenslError):
    """A solver method was called out of sequence (e.g. SetUp before model).

    Mirrors the call-sequence misuse detection tested by the reference in
    ``tests/test_fsp_solver.cpp:127``.
    """


class ModelError(PacmenslError):
    """Invalid model description (dimension mismatches etc.)."""


class IntegratorError(PacmenslError):
    """Fatal failure inside a time integrator (non-finite RHS, divergence)."""


class StateSpaceError(PacmenslError):
    """Invalid state-space operation (bad constraints, dim mismatch)."""


# --- ODE solver status codes (reference OdeSolverBase.h:114) --------------
ODE_SUCCESS = 0          #: integration reached t_final
ODE_FSP_STOP = 1         #: FSP tolerance violated; state space must expand
ODE_FAILURE = -1         #: fatal error (bad matvec, max rejections, ...)


def check_status(status: int, what: str = "ODE solve") -> None:
    """Raise if ``status`` signals a fatal error."""
    if status not in (ODE_SUCCESS, ODE_FSP_STOP):
        raise IntegratorError(f"{what} failed with status {status}")
