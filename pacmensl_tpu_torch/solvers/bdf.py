"""Adaptive variable-order BDF integrator (CVODE parity).

Counterpart of ``pacmensl_tpu/solvers/bdf.py`` (the reference's SUNDIALS
CVODE backend, ``src/OdeSolver/CvodeFsp.cpp``: BDF with matrix-free SPGMR
and no preconditioner): a quasi-constant-step variable-order BDF(1-5) in
the style of CVODE and scipy, with the corrector solved exactly by
matrix-free GMRES, since the FSP right-hand side is linear in p.  The
constants, the first-step heuristic, the difference-array rescaling
(``_compute_RU``), the error norm, the order adaptation after q + 1 equal
steps and the failure rules are the reference package's, so both take the
same steps.

The adaptive loop runs on the host.  The difference array ``D`` holds
``ND`` box vectors (``[ND, n]`` plus ``[ND, n_c]``), allocated once per
vector shape and updated in place; the GMRES basis likewise.  Host syncs
per step, besides GMRES's own (see ``ops/gmres.py``): one for the error
norm with the finiteness flags, one for the sinks in the stop-check of an
accepted step, and one for the two neighbouring-order error norms when the
order adapts.

FSP stop semantics mirror CvodeFsp::Solve (CvodeFsp.cpp:34-78): the
stop-check runs after every accepted step; on violation the solver keeps
the last accepted state and returns status 1.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import vecops as vo
from ..ops.gmres import gmres
from .base import (MatVec, StopCheck, SolveResult, SolveStats, StepRing,
                   STATUS_OK, STATUS_FSP_STOP, STATUS_FAILURE,
                   wrap_stop_check)

MAX_ORDER = 5
ND = MAX_ORDER + 3          # difference-array slots

_KAPPA = np.array([0.0, -0.1850, -1 / 9, -0.0823, -0.0415, 0.0])
_GAMMA = np.concatenate([[0.0], np.cumsum(1.0 / np.arange(1, MAX_ORDER + 1))])
_ALPHA = (1 - _KAPPA) * _GAMMA
_ERRC = _KAPPA * _GAMMA + 1.0 / np.arange(1, MAX_ORDER + 2)

MIN_FACTOR, MAX_FACTOR, SAFETY = 0.2, 10.0, 0.9
#: consecutive error-test/linear-solve failures before declaring a fatal
#: error (CVODE aborts after 7 error-test failures / 10 conv. failures)
MAX_CONSEC_REJ = 25


def _compute_RU(order: int, factor: float) -> np.ndarray:
    """Change-of-step matrix RU = R(factor) @ R(1) for order ``order``
    (CVODE/scipy difference-array rescaling), [q+1, q+1] float64."""
    q = order
    I = np.arange(1, q + 1)[:, None].astype(np.float64)
    J = np.arange(1, q + 1)[None, :].astype(np.float64)

    def R_of(fac):
        M = np.zeros((q + 1, q + 1))
        M[1:, 1:] = (I - 1 - fac * J) / I
        M[0] = 1.0
        return np.cumprod(M, axis=0)

    return R_of(np.float64(factor)) @ R_of(np.float64(1.0))


class BdfSolver:
    """Variable-order BDF(1-5) + matrix-free GMRES over FspVectors."""

    def __init__(self,
                 matvec: MatVec,
                 *,
                 rtol: Optional[float] = None,
                 atol: float = 1.0e-14,
                 gmres_restart: int = 16,
                 gmres_tol: Optional[float] = None,
                 max_steps: int = 10_000_000,
                 stop_check: Optional[StopCheck] = None,
                 trace_cap: int = 4096,
                 n_sinks: Optional[int] = None):
        """``n_sinks``: entries of the stop-check's excess, the leading
        sinks of y (default: all of them; a sensitivity solve's stacked
        vector also holds the sensitivities' sinks)."""
        self.matvec = matvec
        self.n_sinks = n_sinks
        # float64 defaults (the reference package's f64 values)
        self.rtol = float(rtol if rtol is not None else 1.0e-6)
        self.atol = float(atol)
        self.gmres_restart = int(gmres_restart)
        self.gmres_tol = float(gmres_tol if gmres_tol is not None
                               else 1.0e-10)
        self.max_steps = int(max_steps)
        self.trace_cap = int(trace_cap)
        self.stop_check = wrap_stop_check(stop_check)
        self._D: Optional[vo.FspBasis] = None
        self._V: Optional[vo.FspBasis] = None

    # -------------------------------------------------------------- util
    def _storage(self, y: vo.FspVector) -> None:
        """Difference array and GMRES basis, allocated once per vector
        shape and device."""
        D = self._D
        if (D is None or D.p.shape[1:] != y.p.shape
                or D.sinks.shape[1:] != y.sinks.shape
                or D.p.device != y.p.device):
            self._D = self._V = None     # free before allocating anew
            self._D = vo.stack_zeros(y, ND)
            self._V = vo.basis_empty(y, self.gmres_restart + 1)

    def _err_norm_dev(self, err: vo.FspVector,
                      scale_ref: vo.FspVector) -> torch.Tensor:
        """RMS of err / (atol + rtol |ref|) over both parts, divided by the
        total element count (box capacity plus sinks; the ``p`` sum over
        every rank in a sharded solve): a 0-d device tensor."""
        def part(e, yref):
            return torch.sum((e / (self.atol + self.rtol * torch.abs(yref)))
                             ** 2)
        tot = (vo.sum_ranks(part(err.p, scale_ref.p))
               + part(err.sinks, scale_ref.sinks))
        return torch.sqrt(tot / vo.numel(err))

    # ------------------------------------------------------- D updates
    @staticmethod
    def _rescale_D(D: vo.FspBasis, order: int, factor: float) -> None:
        """D[:q+1] <- RU^T D[:q+1], in place."""
        q = order
        RU = _compute_RU(q, factor)
        for part in (D.p, D.sinks):
            M = torch.as_tensor(RU.T, dtype=part.dtype, device=part.device)
            part[:q + 1] = torch.matmul(M, part[:q + 1])

    @staticmethod
    def _predict(D: vo.FspBasis, order: int):
        """(y_pred, psi) for the current order."""
        q = order
        y_pred = vo.basis_get(D, 0)
        for i in range(1, q + 1):
            y_pred = vo.add(y_pred, vo.basis_get(D, i))
        psi = vo.scale(_GAMMA[1] / _ALPHA[q], vo.basis_get(D, 1))
        for i in range(2, q + 1):
            psi = vo.axpy(_GAMMA[i] / _ALPHA[q], vo.basis_get(D, i), psi)
        return y_pred, psi

    @staticmethod
    def _update_D(D: vo.FspBasis, order: int, d: vo.FspVector) -> None:
        """Accepted step: push the new difference, in place."""
        q = order
        for part, dv in ((D.p, d.p), (D.sinks, d.sinks)):
            torch.sub(dv, part[q + 1], out=part[q + 2])
            part[q + 1].copy_(dv)
            for i in range(q, -1, -1):
                part[i].add_(part[i + 1])

    def _adapt_order(self, D: vo.FspBasis, order: int, err_norm,
                     y_pred: vo.FspVector):
        """(new order, step factor) from the error norms at orders q - 1,
        q and q + 1 (scipy BDF), on the updated difference array."""
        zero = torch.zeros((), dtype=D.p.dtype, device=D.p.device)
        e_m = (self._err_norm_dev(vo.scale(float(_ERRC[order - 1]),
                                           vo.basis_get(D, order)), y_pred)
               if order > 1 else zero)
        e_p = (self._err_norm_dev(vo.scale(float(_ERRC[order + 1]),
                                           vo.basis_get(D, order + 2)),
                                  y_pred)
               if order < MAX_ORDER else zero)
        e_m, e_p = torch.stack([e_m, e_p]).cpu().numpy()        # sync
        if order == 1:
            e_m = np.float64(np.inf)
        if order == MAX_ORDER:
            e_p = np.float64(np.inf)
        errs = np.array([e_m, np.maximum(err_norm, 1e-30), e_p])
        pows = np.float64(order) + np.arange(3, dtype=np.float64)
        facs = np.where(errs > 0, errs ** (-1.0 / pows), MAX_FACTOR)
        delta = int(np.argmax(facs)) - 1
        new_order = int(np.clip(order + delta, 1, MAX_ORDER))
        factor = np.clip(SAFETY * np.max(facs), MIN_FACTOR, MAX_FACTOR)
        return new_order, factor

    # ------------------------------------------------------------------
    def solve(self, y0: vo.FspVector, t0, t_final, stop_aux=None
              ) -> SolveResult:
        """Integrate from ``t0`` to ``t_final``; ``stop_aux`` is forwarded
        to the stop-check."""
        t, t_final = np.float64(t0), np.float64(t_final)
        n_c = (y0.sinks.shape[0] if self.n_sinks is None
               else int(self.n_sinks))
        mv = self.matvec

        def fsp_excess(tt, y):
            if self.stop_check is None:
                return np.full(n_c, -1.0)
            return np.asarray(self.stop_check(float(tt), y, stop_aux),
                              np.float64).reshape(n_c)

        self._storage(y0)
        D, V = self._D, self._V
        D.p.zero_()
        D.sinks.zero_()

        with np.errstate(all="ignore"):
            # ---- initial h (order-1 heuristic, as scipy BDF)
            f0 = mv(float(t), y0)
            d1 = np.float64(float(self._err_norm_dev(f0, y0)))   # sync
            h0 = (np.float64(0.01) / np.maximum(d1, 1e-30) if d1 > 0
                  else np.float64(1e-6))
            h = np.minimum(np.maximum(h0, 1e-12), t_final - t)
            vo.basis_set(D, 0, y0)
            vo.basis_set(D, 1, vo.scale(float(h), f0))
            del f0

            order, n_eq, status = 1, 0, STATUS_OK
            n_steps, n_rej, n_mv, stop, n_consec = 0, 0, 1, 0, 0
            viol = np.full(n_c, -np.inf)
            tr = StepRing(self.trace_cap) if self.trace_cap > 0 else None
            eps = np.finfo(np.float64).eps

            while (t < t_final and status == STATUS_OK and stop == 0
                   and n_steps + n_rej < self.max_steps):
                # truncate the final step; D encodes the step size, so
                # rescale (as scipy BDF does when hitting t_bound)
                h_clamped = np.minimum(h, t_final - t)
                clamp_fac = h_clamped / h
                if clamp_fac < 1.0 - 1e-12:
                    self._rescale_D(D, order, clamp_fac)
                h = h_clamped
                t_new = t + h
                c = h / _ALPHA[order]
                t_mv = float(t_new)
                order_step = order

                y_pred, psi = self._predict(D, order)

                # linear solve: (I - c A) d = c A y_pred - psi
                def apply_M(v):
                    return vo.axpy(-float(c), mv(t_mv, v), v)

                rhs = vo.sub(vo.scale(float(c), mv(t_mv, y_pred)), psi)
                sol = gmres(apply_M, rhs, vo.zeros_like(rhs),
                            restart=self.gmres_restart, tol=self.gmres_tol,
                            atol=self.atol, basis=V)
                d = sol.x
                n_mv += sol.n_matvecs + 1
                y_new = vo.add(y_pred, d)

                err_dev = self._err_norm_dev(
                    vo.scale(float(_ERRC[order]), d), y_pred)
                # a non-finite rhs means the user matvec failed: propagate
                # at once (GMRES would return x0 unchanged on a NaN rhs)
                flags = torch.stack([
                    err_dev, vo.isfinite(rhs).to(err_dev.dtype),
                    vo.isfinite(y_new).to(err_dev.dtype)]).cpu().numpy()
                err_norm = flags[0]                             # sync
                rhs_finite, y_finite = bool(flags[1]), bool(flags[2])
                healthy = y_finite and np.isfinite(err_norm) and rhs_finite
                accept = bool(err_norm <= 1.0) and healthy and sol.converged
                if not healthy:
                    status = STATUS_FAILURE

                if accept:
                    # FSP stop-check (CvodeFsp semantics: revert + stop)
                    excess_v = fsp_excess(t_new, y_new)          # sync
                    viol = np.maximum(viol, excess_v)
                    violated = bool(np.max(excess_v) > 0.0)
                else:
                    violated = False
                if violated:
                    stop = 1
                advance = accept and not violated

                if advance:
                    self._update_D(D, order, d)
                    n_eq_new = n_eq + 1
                    if n_eq_new >= order + 1:
                        order, factor = self._adapt_order(
                            D, order, err_norm, y_pred)
                        n_eq = 0
                    else:
                        factor, n_eq = np.float64(1.0), n_eq_new
                    t_out = t_new
                else:
                    if accept:
                        factor = np.float64(1.0)
                    elif sol.converged:
                        factor = np.clip(
                            SAFETY * err_norm ** (-1.0 / (order + 1.0)),
                            MIN_FACTOR, 1.0)
                    else:
                        factor = np.float64(0.5)   # linear solve stalled
                    n_eq = 0
                    t_out = t
                h_new = h * factor
                # keep h in range and rescale D accordingly
                if np.abs(factor - 1.0) > 1e-12:
                    self._rescale_D(D, order, factor)

                if advance and tr is not None:
                    tr.record(n_steps, float(t_new), float(h), order_step)
                n_steps += int(advance)
                n_rej += int(not accept)
                n_consec = 0 if accept else n_consec + 1
                if n_consec >= MAX_CONSEC_REJ and status == STATUS_OK:
                    status = STATUS_FAILURE
                # minimum-step safeguard (scipy BDF min_step): a rejection
                # that drives h below float resolution of the time span is
                # fatal
                min_step = 10.0 * eps * np.maximum(np.abs(t_out),
                                                   np.abs(t_final))
                if (not accept) and h_new < min_step and status == STATUS_OK:
                    status = STATUS_FAILURE
                t, h = t_out, h_new
                del y_pred, psi, rhs, sol, d, y_new

        if status == STATUS_OK and stop == 1:
            status = STATUS_FSP_STOP
        if status == STATUS_OK and t < t_final:
            status = STATUS_FAILURE              # max_steps exhausted
        y = vo.FspVector(p=D.p[0].clone(), sinks=D.sinks[0].clone())
        return SolveResult(y=y, t=float(t), status=status,
                           stats=SolveStats(n_steps, n_rej, n_mv),
                           viol_excess=viol, trace=tr)
