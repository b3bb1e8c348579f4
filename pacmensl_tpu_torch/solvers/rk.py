"""Adaptive explicit Runge-Kutta integrator (TsFsp parity).

Counterpart of ``pacmensl_tpu/solvers/rk.py`` (the reference's PETSc TS
adapter, ``src/OdeSolver/TsFsp.cpp``, default type "rk"): Dormand-Prince
5(4) with the clip-and-safety step controller.  The tableau, the seven
right-hand-side evaluations a step (the reference package evaluates the
FSAL stage anew each step), the two evaluations of the first-step
heuristic, the weighted RMS error norm over every element of both parts
of the vector and the controller are the reference package's, so both
take the same steps on the same operator.

FSP stop handling mirrors TsFsp's post-evaluate retry
(``TsFsp.cpp:128-198``): where an accepted step breaks the FSP tolerance,
the step is retried from the previous state with half the step size, up
to 10 trials; the solver then returns status 1 at a time where the check
passes, or, after 10 halvings, at the previous state.

The adaptive loop runs on the host, over :class:`~..ops.vecops.FspVector`
values on their device.  A step's decision comes to the host in one copy
(``HostSync.RKDecision``): the error norm, the finiteness flag and the
stop-check's excess, stacked (a stop-check that returns a device tensor
adds no copy of its own); the first-step heuristic's norms in two
(``HostSync.RKStartNorms``).  On
a mesh (:func:`~..ops.vecops.reductions_over`) the error norm's and the
finiteness flag's partial sums over each rank's slab are all-reduced
together, one collective a step, so every rank takes the same steps.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import vecops as vo
from .base import (MatVec, StopCheck, SolveResult, SolveStats, StepRing,
                   STATUS_OK, STATUS_FSP_STOP, STATUS_FAILURE,
                   wrap_stop_check)

# Dormand-Prince 5(4) tableau
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_A = np.array([
    [0, 0, 0, 0, 0, 0],
    [1 / 5, 0, 0, 0, 0, 0],
    [3 / 40, 9 / 40, 0, 0, 0, 0],
    [44 / 45, -56 / 15, 32 / 9, 0, 0, 0],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0],
])
_B = np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84])
# embedded 4th-order weights
_B4 = np.array([5179 / 57600, 0, 7571 / 16695, 393 / 640,
                -92097 / 339200, 187 / 2100, 1 / 40])
#: most halvings of a step that breaks the FSP tolerance
MAX_HALVINGS = 10
#: the step trace's method-specific entry for every accepted step (the
#: reference package's: the stage count)
TRACE_AUX = 7


class RKSolver:
    """Dormand-Prince 5(4) over FspVectors."""

    _err_exp = -0.2          # -1/(embedded order + 1) = -1/5

    def __init__(self,
                 matvec: MatVec,
                 *,
                 rtol: Optional[float] = None,
                 atol: float = 1.0e-14,
                 safety: float = 0.9,
                 max_steps: int = 10_000_000,
                 stop_check: Optional[StopCheck] = None,
                 trace_cap: int = 4096,
                 n_sinks: Optional[int] = None):
        """``n_sinks``: entries of the stop-check's excess (default: all
        of y's sinks)."""
        self.matvec = matvec
        # float64 default (the reference package's f64 value)
        self.rtol = float(rtol if rtol is not None else 1.0e-6)
        self.atol = float(atol)
        self.safety = float(safety)
        self.max_steps = int(max_steps)
        self.trace_cap = int(trace_cap)
        self.n_sinks = n_sinks
        self.stop_check = wrap_stop_check(stop_check)

    # ------------------------------------------------------------------
    def _err_parts(self, err: vo.FspVector, a: vo.FspVector,
                   b: vo.FspVector):
        """Sum of (e / (atol + rtol max(|a|, |b|)))^2 over the rank's
        ``p`` and over the sinks: two 0-d device tensors."""
        def part(e, x, y):
            scale = self.atol + self.rtol * torch.maximum(torch.abs(x),
                                                          torch.abs(y))
            return torch.sum((e / scale) ** 2)
        return part(err.p, a.p, b.p), part(err.sinks, a.sinks, b.sinks)

    def _err_norms(self, pairs) -> np.ndarray:
        """The weighted RMS norms (CVODE/scipy style) of ``pairs``, each
        ``(err, a, b)``, over every element of every rank: one
        all-reduce and one copy to the host."""
        parts = [self._err_parts(*q) for q in pairs]
        ps = vo.sum_ranks(torch.stack([p for p, _ in parts]))
        tot = ps + torch.stack([s for _, s in parts])
        return vo.to_host(torch.sqrt(tot / vo.numel(pairs[0][0])),
                          "RKStartNorms")

    def _rk_step(self, mv, t, y, h):
        """One DP5(4) step: ``(y5, err, matvecs)``."""
        ks = []
        for i in range(6):
            yi = y
            for j in range(i):
                if _A[i, j] != 0.0:
                    yi = vo.axpy(h * _A[i, j], ks[j], yi)
            ks.append(mv(t + _C[i] * h, yi))
        y5 = y
        for i in range(6):
            if _B[i] != 0.0:
                y5 = vo.axpy(h * _B[i], ks[i], y5)
        ks.append(mv(t + h, y5))          # the FSAL stage, evaluated anew
        # error = y5 - y4
        err = None
        for i in range(7):
            d = _B[i] - _B4[i] if i < 6 else -_B4[6]
            if d != 0.0:
                err = (vo.scale(h * d, ks[i]) if err is None
                       else vo.axpy(h * d, ks[i], err))
        return y5, err, 7

    def _initial_step(self, mv, t0, y0, t_final):
        """scipy-style first step (order 5): two right-hand sides."""
        f0 = mv(t0, y0)
        d0, d1 = self._err_norms([(y0, y0, y0), (f0, y0, y0)])   # sync
        h0 = (np.float64(1e-6) if (d0 < 1e-5) | (d1 < 1e-5)
              else 0.01 * d0 / d1)
        y1 = vo.axpy(float(h0), f0, y0)
        f1 = mv(float(t0 + h0), y1)
        d2 = self._err_norms([(vo.sub(f1, f0), y0, y0)])[0] / h0  # sync
        h1 = (np.maximum(1e-6, h0 * 1e-3) if (d1 <= 1e-15) & (d2 <= 1e-15)
              else (0.01 / np.maximum(d1, d2)) ** (1.0 / 6.0))
        return np.minimum(100 * h0, np.minimum(h1, t_final - t0))

    def _decision(self, err, y, y5, t_new, n_c, stop_aux) -> np.ndarray:
        """``[error norm, y5 finite, excess_1..excess_n_c]`` on the host,
        in one copy after one all-reduce (of the error's and the
        non-finite entries' partial sums over the ranks)."""
        ep, es = self._err_parts(err, y, y5)
        bad_p = (~torch.isfinite(y5.p)).sum().to(ep.dtype)
        red = vo.sum_ranks(torch.stack([ep, bad_p]))
        enorm = torch.sqrt((red[0] + es) / vo.numel(err))
        finite = ((red[1] == 0) & torch.isfinite(y5.sinks).all()
                  ).to(ep.dtype)
        if self.stop_check is None:
            excess = torch.full((n_c,), -1.0, dtype=ep.dtype,
                                device=ep.device)
        else:
            excess = torch.as_tensor(
                self.stop_check(float(t_new), y5, stop_aux),
                dtype=ep.dtype).to(ep.device).reshape(n_c)
        return vo.to_host(torch.cat([torch.stack([enorm, finite]), excess]),
                          "RKDecision")                           # sync

    # ------------------------------------------------------------------
    def solve(self, y0: vo.FspVector, t0, t_final, stop_aux=None
              ) -> SolveResult:
        """Integrate from ``t0`` to ``t_final``; ``stop_aux`` is forwarded
        to the stop-check."""
        t, t_final = np.float64(t0), np.float64(t_final)
        n_c = (y0.sinks.shape[0] if self.n_sinks is None
               else int(self.n_sinks))
        mv = self.matvec
        tr = StepRing(self.trace_cap) if self.trace_cap > 0 else None
        with np.errstate(all="ignore"):
            h = self._initial_step(mv, float(t), y0, t_final)
            y = y0
            status, n_steps, n_rej, n_mv, stop, n_halve = (STATUS_OK, 0, 0,
                                                           2, 0, 0)
            viol = np.full(n_c, -np.inf)
            while (t < t_final and status == STATUS_OK and stop == 0
                   and n_steps + n_rej < self.max_steps):
                h = np.minimum(h, t_final - t)
                y5, err, n_stage = self._rk_step(mv, float(t), y, float(h))
                n_mv += n_stage
                dec = self._decision(err, y, y5, t + h, n_c, stop_aux)
                enorm, finite, excess_v = dec[0], bool(dec[1]), dec[2:]
                finite = finite and np.isfinite(enorm)
                accept = bool(enorm <= 1.0) and finite
                # the controller (exponent -1/(order + 1) of the embedded
                # estimate; subclasses of other orders override it)
                factor = (np.clip(self.safety * enorm ** self._err_exp,
                                  0.2, 10.0) if enorm > 0
                          else np.float64(10.0))
                h_new = h * factor
                if not finite:
                    status = STATUS_FAILURE
                # the FSP check on accepted steps: a violation halves h
                # and retries from y
                if accept:
                    viol = np.maximum(viol, excess_v)
                excess = np.max(excess_v) if accept else -1.0
                violated = accept and excess > 0.0 and n_halve < MAX_HALVINGS
                give_up = accept and excess > 0.0 and n_halve >= MAX_HALVINGS
                advance = accept and excess <= 0.0
                # a step that passes after a halving stops the epoch; after
                # 10 failed halvings stay at the previous state (the
                # reference takes t_step = 0 on its last trial)
                if (advance and n_halve > 0) or give_up:
                    stop = 1
                if violated:
                    h_out = 0.5 * h
                elif advance or not accept:
                    h_out = h_new
                else:
                    h_out = h
                n_halve = (n_halve + 1 if violated
                           else 0 if advance else n_halve)
                if advance:
                    if tr is not None:
                        tr.record(n_steps, float(t + h), float(h), TRACE_AUX)
                    y, t = y5, t + h
                n_steps += int(advance)
                n_rej += int(not (advance or give_up))
                h = h_out
                del y5, err
        if status == STATUS_OK and stop == 1:
            status = STATUS_FSP_STOP
        if status == STATUS_OK and t < t_final:
            status = STATUS_FAILURE              # max_steps exhausted
        return SolveResult(y=y, t=float(t), status=status,
                           stats=SolveStats(n_steps, n_rej, n_mv),
                           viol_excess=viol, trace=tr)
