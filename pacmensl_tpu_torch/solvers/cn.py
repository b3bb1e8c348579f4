"""Implicit trapezoid (Crank-Nicolson) integrator: TsFsp's "-ts_type cn".

Counterpart of ``pacmensl_tpu/solvers/cn.py``.  The reference's TsFsp
adapter takes any PETSc TS method and wires ``IFunction F = A p - p'``
and ``IJacobian A - aI`` for the implicit ones
(``src/OdeSolver/TsFsp.cpp:227-274``).  Here the trapezoid rule

    (I - h/2 A(t+h)) y1 = (I + h/2 A(t)) y0

is solved with the port's matrix-free GMRES (``ops/gmres.py``), as BDF's
corrector is.  The local error is estimated with an embedded
backward-Euler companion solve, ``err = y_CN - y_BE``: backward Euler is
first order, so the estimate is the leading local-error term and the
controller's exponent is -1/2.  The step loop, the controller and the FSP
halve-and-retry are :class:`~.rk.RKSolver`'s.
"""
from __future__ import annotations

from ..ops import vecops as vo
from ..ops.gmres import gmres
from .rk import RKSolver


class CNSolver(RKSolver):
    """Adaptive Crank-Nicolson with a backward-Euler error estimate."""

    _err_exp = -0.5          # the embedded estimate is of order 1

    def _rk_step(self, mv, t, y, h):
        """One trapezoid step and its backward-Euler companion:
        ``(y1, err, matvecs)``."""
        lin_tol = max(1.0e-2 * self.rtol, 1.0e-14)
        f0 = mv(t, y)
        rhs = vo.axpy(0.5 * h, f0, y)
        t1 = t + h

        def A_cn(v):
            return vo.axpy(-0.5 * h, mv(t1, v), v)      # (I - h/2 A) v

        res = gmres(A_cn, rhs, y, tol=lin_tol, atol=self.atol)
        y1 = res.x

        def A_be(v):
            return vo.axpy(-h, mv(t1, v), v)            # (I - h A) v

        res_be = gmres(A_be, y, y1, tol=lin_tol, atol=self.atol)
        err = vo.sub(y1, res_be.x)
        n_mv = 1 + res.n_matvecs + res_be.n_matvecs
        # a stalled linear solve must reject the step, not pass it: the
        # error estimate is inflated where either GMRES did not converge
        if not (res.converged and res_be.converged):
            err = vo.axpy(1.0, y1, err)
        return y1, err, n_mv
