"""Adaptive Krylov exponential integrator (KrylovFsp parity).

Counterpart of ``pacmensl_tpu/solvers/krylov.py`` (the reference's
EXPOKIT-style integrator, ``src/OdeSolver/KrylovFsp.cpp:101-322``):
incomplete orthogonalization (IOP window q), adaptive step size and
adaptive Krylov dimension m in [m_min, m_max] chosen by a cost model,
local error from the last Hessenberg entries, dense ``expm`` of the small
Hessenberg matrix, solution update ``y = beta * Vm @ F[:, 0]``, and the
FSP stop-check with its step-halving retry.  Defaults, the first-step
heuristic, the error estimate, the rejection loop and the cost model are
the reference package's, so both take the same steps.

The loop runs on the host; vectors stay on their device.  Host syncs per
step (each marked ``sync`` below): the norm of y, the norm of each new
Arnoldi vector (the happy-breakdown test decides whether the basis
grows), one copy of the Hessenberg coefficients, the norms of the
first-step and error-estimate matvecs, and the sinks for the stop-check.
The Hessenberg exponentials run on the host in float64.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops import vecops as vo
from ..ops.expm import expm
from .base import (MatVec, StopCheck, SolveResult, SolveStats, StepRing,
                   STATUS_OK, STATUS_FSP_STOP, STATUS_FAILURE,
                   wrap_stop_check)


def _int_ceil(v: float) -> int:
    """ceil(v) as an int, saturating like the reference's int32 cast."""
    if math.isnan(v):
        return -2 ** 31
    return int(math.ceil(min(max(v, -2.0 ** 31), 2.0 ** 31 - 1)))


class KrylovSolver:
    """Adaptive Krylov expm integrator over :class:`FspVector` values."""

    def __init__(self,
                 matvec: MatVec,
                 *,
                 abs_tol: Optional[float] = None,
                 m_min: int = 25,
                 m_max: int = 60,
                 q_iop: int = 2,
                 btol: Optional[float] = None,
                 delta: float = 1.2,
                 gamma: float = 0.9,
                 max_reject: int = 100,
                 max_steps: int = 1_000_000,
                 rhs_cost: float = 1.0e4,
                 stop_check: Optional[StopCheck] = None,
                 trace_cap: int = 4096,
                 n_sinks: Optional[int] = None):
        """``n_sinks``: entries of the stop-check's excess, the leading
        sinks of y (default: all of them; a sensitivity solve's stacked
        vector also holds the sensitivities' sinks)."""
        self.matvec = matvec
        self.n_sinks = n_sinks
        # float64 throughout: the reference's 1e-14 tolerances
        self.abs_tol = float(abs_tol if abs_tol is not None else 1.0e-14)
        self.m_min = int(m_min)
        self.m_max = int(m_max)
        self.q_iop = int(q_iop)
        self.btol = float(btol if btol is not None else 1.0e-14)
        self.delta = float(delta)
        self.gamma = float(gamma)
        self.max_reject = int(max_reject)
        self.max_steps = int(max_steps)
        self.rhs_cost = float(rhs_cost)
        self.trace_cap = int(trace_cap)
        self.stop_check = wrap_stop_check(stop_check)
        self._V: Optional[vo.FspBasis] = None

    # ------------------------------------------------------------------
    def _basis_storage(self, y: vo.FspVector) -> vo.FspBasis:
        """Basis of m_max + 1 vectors, allocated once per vector shape."""
        V = self._V
        if (V is None or V.p.shape[1:] != y.p.shape
                or V.sinks.shape[1:] != y.sinks.shape
                or V.p.device != y.p.device):
            self._V = None           # free before allocating the new one
            V = self._V = vo.basis_empty(y, self.m_max + 1)
        return V

    def _basis(self, t_eval, y, beta, m):
        """IOP Arnoldi: returns (Hm [M2, M2] host, mb, k1, n_mv, finite)."""
        M2 = self.m_max + 2
        V = self._V
        with np.errstate(all="ignore"):
            inv_beta = float(np.float64(1.0) / beta)
        torch.mul(y.p, inv_beta, out=V.p[0])
        torch.mul(y.sinks, inv_beta, out=V.sinks[0])
        Hm = np.zeros((M2, M2))
        h_pos, h_dev = [], []
        j, happy, nmv = 0, False, 0
        while j < m and not happy:
            w = self.matvec(t_eval, vo.basis_get(V, j))
            nmv += 1
            istart = max(0, j - self.q_iop + 1) if self.q_iop > 0 else 0
            for i in range(istart, j + 1):
                vi = vo.basis_get(V, i)
                h = vo.vdot(w, vi)
                w.p.addcmul_(vi.p, -h)
                w.sinks.addcmul_(vi.sinks, -h)
                h_pos.append((i, j))
                h_dev.append(h)
            s = float(vo.norm2(w))                       # sync
            happy = s < self.btol
            inv = 1.0 / (1.0 if happy else s)
            torch.mul(w.p, inv, out=V.p[j + 1])
            torch.mul(w.sinks, inv, out=V.sinks[j + 1])
            Hm[j + 1, j] = s
            j += 1
        if h_dev:
            hv = torch.stack(h_dev).cpu().numpy()        # sync
            for (i, jj), v in zip(h_pos, hv):
                Hm[i, jj] = v
        mb = j if happy else m          # j+1 basis vectors on breakdown
        k1 = 0 if happy else 2
        # The reference also tests the last basis vector's norm; a
        # non-finite vector there implies a non-finite Hessenberg entry.
        finite = bool(np.isfinite(Hm).all())
        return Hm, mb, k1, nmv, finite

    # ------------------------------------------------------------------
    def solve(self, y0: vo.FspVector, t0, t_final, stop_aux=None
              ) -> SolveResult:
        """Integrate from ``t0`` to ``t_final``; ``stop_aux`` is forwarded
        to the stop-check."""
        t_now, t_final = float(t0), float(t_final)
        n_c = (y0.sinks.shape[0] if self.n_sinks is None
               else int(self.n_sinks))
        M1 = self.m_max + 1
        nvec_total = vo.numel(y0)
        q = float(self.q_iop)
        self._basis_storage(y0)
        V = self._V

        def fsp_excess(t, y):
            if self.stop_check is None:
                return np.full(n_c, -1.0)
            return np.asarray(self.stop_check(t, y, stop_aux),
                              np.float64).reshape(n_c)

        def lincomb(F, mx):
            coeffs = torch.from_numpy(beta * F[:M1, 0][:mx].copy())
            return vo.basis_lincomb(coeffs, V)

        y = y0
        t_step_next, m_next, first_init = 0.0, self.m_min, False
        status, n_steps, n_rej, n_mv, stop = STATUS_OK, 0, 0, 0, 0
        viol = np.full(n_c, -np.inf)
        tr = StepRing(self.trace_cap) if self.trace_cap > 0 else None

        while (t_now < t_final and status == STATUS_OK and stop == 0
               and n_steps < self.max_steps):
            m = min(max(m_next, self.m_min), self.m_max)
            beta = np.float64(float(vo.norm2(y)))        # sync
            # coefficients frozen at the step's predicted midpoint (the
            # reference package's choice; exact for time-invariant models)
            t_eval = t_now + 0.5 * min(max(t_step_next, 0.0),
                                       t_final - t_now)
            Hm, mb, k1, nmv_b, finite = self._basis(t_eval, y, beta, m)
            n_mv += nmv_b
            if not (finite and math.isfinite(beta)):
                # the reference package finishes this step on non-finite
                # data and then stops; nothing of it is usable
                status = STATUS_FAILURE
                n_steps += 1
                break

            # Scalar step control in numpy float64, so inf and NaN propagate
            # as in the reference package instead of raising.
            with np.errstate(all="ignore"):
                # --- first-step heuristic (KrylovFsp.cpp:133-144)
                if first_init:
                    t_step_next2 = np.float64(t_step_next)
                else:
                    av = self.matvec(t_eval, y)
                    anorm = np.float64(float(vo.norm2(av))) / beta  # sync
                    mf = np.float64(m)
                    fact = np.power((mf + 1) / np.exp(1.0), mf + 1) * \
                        np.sqrt(2 * np.pi * (mf + 1))
                    t_step_next2 = (1.0 / anorm) * np.power(
                        (fact * self.abs_tol) / (4.0 * beta * anorm),
                        1.0 / mf)
                    n_mv += 1

                # --- avnorm for the error estimator (KrylovFsp.cpp:148-155)
                Hm2 = Hm
                avnorm = np.float64(1.0)
                if k1 != 0:
                    Hm2 = Hm.copy()
                    Hm2[mb + 1, mb] = 1.0
                    av = self.matvec(t_eval, vo.basis_get(V, mb))
                    avnorm = np.float64(float(vo.norm2(av)))   # sync
                    n_mv += 1
                Hm2_t = torch.from_numpy(Hm2)

                # --- rejection loop: shrink tau until the local error passes
                t_step, ts, m_sugg = np.float64(0.0), np.float64(0.0), m
                omega, t_step_old = np.float64(0.0), np.float64(1.0)
                order = np.float64(m) / 4.0
                ir, success, F = 0, False, np.zeros_like(Hm2)
                while (not success) and ir <= self.max_reject:
                    tau = (np.minimum(t_final - t_now, t_step_next2)
                           if ir == 0
                           else np.maximum(0.2 * t_step, 0.5 * t_step))
                    F = expm(tau * Hm2_t).numpy()
                    phi1 = np.abs(beta * F[mb, 0])
                    phi2 = np.abs(beta * F[mb + 1, 0] * avnorm)
                    err_loc = np.where(
                        phi1 > 10.0 * phi2, phi2,
                        np.where(phi1 > phi2,
                                 (phi1 * phi2) / (phi1 - phi2), phi1))
                    # happy breakdown: expm(tau*Hm) is exact for any tau
                    if k1 == 0:
                        err_loc = np.float64(0.0)
                    omega_prev = omega
                    omega = err_loc / (self.abs_tol * tau)
                    omega_s = np.maximum(omega, 1.0e-16)
                    if ir > 0:
                        order = np.maximum(1.0, np.log(
                            omega_s / np.maximum(omega_prev, 1.0e-16)) /
                            np.log(tau / t_step_old))
                    # step-size suggestion with decimal rounding
                    # (KrylovFsp.cpp:193-197)
                    ts = self.gamma * tau * np.power(omega_s, -1.0 / order)
                    sdig = np.power(10.0, np.floor(np.log10(ts)) - 1)
                    ts = np.ceil(ts / sdig) * sdig
                    ts = np.clip(ts, 0.2 * tau, 5.0 * tau)
                    ts = np.minimum(t_final - t_now, ts)
                    # dimension suggestion (KrylovFsp.cpp:199-201), kappa=2
                    msug = m + _int_ceil(float(
                        np.log(omega_s / self.gamma) / np.log(2.0)))
                    msug = min(max(msug, 3 * m // 4), 4 * m // 3 + 1)
                    m_sugg = min(max(msug, self.m_min), self.m_max)
                    success = bool(omega <= self.delta)
                    t_step, t_step_old = tau, tau
                    ir += 1
                n_rej += max(ir - 1, 0)
                if not success and status == STATUS_OK:
                    status = STATUS_FAILURE

                # --- cost model: change tau or change m?
                # (KrylovFsp.cpp:203-216)
                hnorm = np.abs(Hm2).sum(axis=1).max()

                def est_cost(tau_new, m_new):
                    ns = np.ceil(hnorm * tau_new)
                    mf = np.float64(m_new)
                    return ((mf + 1) * self.rhs_cost +
                            (4 * q * mf + 5 * mf + 2 * q - 2 * q * q + 7)
                            * nvec_total +
                            2.0 * np.ceil(25.0 / 3.0 + ns) * (mf + 2) ** 3)

                nt = np.ceil((t_final - t_now) / ts) * est_cost(ts, m)
                nm = np.ceil((t_final - t_now) / t_step) * \
                    est_cost(t_step, m_sugg)
                if nt <= nm or m_sugg == m:
                    t_step_next, m_next = float(ts), m
                else:
                    t_step_next, m_next = float(t_step), m_sugg
                t_step = float(t_step)

            # --- accept: y(t+tau) = beta * Vm @ F[:, 0] over mx columns
            mx = mb + max(0, k1 - 1)
            y_new = lincomb(F, mx)
            t_new = t_now + t_step

            # --- FSP stop-check + halving interpolation (GetDky analogue)
            excess = fsp_excess(t_new, y_new)            # sync
            viol = np.maximum(viol, excess)
            nrej_h = 0
            while excess.max() > 0.0 and nrej_h < 10:
                nrej_h += 1
                tau_try = 0.0 if nrej_h >= 10 else 0.5 * (t_new - t_now)
                y_new = lincomb(expm(tau_try * Hm2_t).numpy(), mx)
                t_new = t_now + tau_try
                excess = fsp_excess(t_new, y_new)        # sync
                stop = 1
                viol = np.maximum(viol, excess)
            if tr is not None:
                tr.record(n_steps, t_new, t_new - t_now, m)

            y, t_now, first_init = y_new, t_new, True
            n_steps += 1

        if status == STATUS_OK and stop == 1:
            status = STATUS_FSP_STOP
        return SolveResult(y=y, t=t_now, status=status,
                           stats=SolveStats(n_steps, n_rej, n_mv),
                           viol_excess=viol, trace=tr)
