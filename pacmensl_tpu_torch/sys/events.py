"""Event logging: named phase timers and the per-step integrator trace.

Counterpart of ``pacmensl_tpu/sys/events.py`` (the reference's PETSc
event-log system, ``FspSolverMultiSinks.cpp:283-301`` and
``ReduceComponentTiming`` at ``:467-516``), with the same phase names.
The port runs in one process, so :meth:`EventLog.reduce` returns
(min, max, sum) of the local time with all three equal.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

# Canonical event names, mirroring the phases the reference registers.
EVT_SETUP = "Setup"
EVT_PARTITION = "StatePartitioning"
EVT_MATGEN = "MatrixGeneration"
EVT_ODESOLVE = "ODESolve"
EVT_RHS = "RHSEvaluation"
EVT_SCATTER = "SolutionScatter"
EVT_TOTAL = "Solving"


@dataclass
class EventRecord:
    count: int = 0
    total_s: float = 0.0
    flops: float = 0.0


@dataclass
class StepTrace:
    """Per-accepted-step trace (reference FiniteProblemSolverPerfInfo,
    ``OdeSolverBase.cpp:105-132``): model time at step end, step size,
    method detail (Krylov m), active equation count, and the epoch's host
    wall clock.  The integrator records steps into a fixed-capacity ring
    (:class:`~..solvers.base.StepRing`) that is drained here once per
    epoch; on overflow the oldest steps are dropped and counted in
    ``truncated``."""
    model_time: List[float] = field(default_factory=list)
    step_h: List[float] = field(default_factory=list)
    aux: List[int] = field(default_factory=list)
    n_eqs: List[int] = field(default_factory=list)
    wall_time: List[float] = field(default_factory=list)
    truncated: int = 0

    def record_epoch(self, n_steps: int, trace, n_eqs: int):
        """Drain one epoch's ring ``trace = (t, h, aux)`` arrays holding
        ``n_steps`` recorded steps, in chronological order."""
        if trace is None:
            return
        n_steps = int(n_steps)
        if n_steps <= 0:
            return
        t_d, h_d, aux_d = trace
        t = np.asarray(t_d, dtype=float)
        h = np.asarray(h_d, dtype=float)
        aux = np.asarray(aux_d, dtype=int)
        cap = t.shape[0]
        if n_steps > cap:                  # ring wrapped
            start = n_steps % cap
            order = np.r_[start:cap, 0:start]
            t, h, aux = t[order], h[order], aux[order]
            self.truncated += n_steps - cap
            k = cap
        else:
            k = n_steps
        wall = time.perf_counter()
        self.model_time.extend(t[:k].tolist())
        self.step_h.extend(h[:k].tolist())
        self.aux.extend(aux[:k].tolist())
        self.n_eqs.extend([int(n_eqs)] * k)
        self.wall_time.extend([wall] * k)

    @property
    def n_steps(self) -> int:
        return len(self.model_time)


class EventLog:
    """Named wall-clock phase timers with nesting support."""

    def __init__(self):
        self.events: Dict[str, EventRecord] = {}

    @contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            rec = self.events.setdefault(name, EventRecord())
            rec.count += 1
            rec.total_s += dt

    def add(self, name: str, seconds: float):
        rec = self.events.setdefault(name, EventRecord())
        rec.count += 1
        rec.total_s += seconds

    def add_count(self, name: str, count: int, seconds: float = 0.0,
                  flops: float = 0.0):
        """Accumulate an event counted by the integrator (e.g. RHS
        evaluations): the count and FLOPs are exact; wall seconds only if
        the caller measured them."""
        rec = self.events.setdefault(name, EventRecord())
        rec.count += int(count)
        rec.total_s += float(seconds)
        rec.flops += float(flops)

    def reduce(self):
        """(min, max, sum) of each event's wall time; one process, so the
        three entries are equal (``ReduceComponentTiming`` parity)."""
        return {k: (v.total_s, v.total_s, v.total_s)
                for k, v in self.events.items()}

    def report(self) -> str:
        lines = [f"{'event':<24}{'count':>10}{'total_s':>14}{'gflops':>10}"]
        for name, rec in sorted(self.events.items()):
            lines.append(f"{name:<24}{rec.count:>10}{rec.total_s:>14.6f}"
                         f"{rec.flops / 1e9:>10.3f}")
        return "\n".join(lines)
