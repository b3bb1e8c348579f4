"""Event logging: named phase timers and the per-step integrator trace.

Counterpart of ``pacmensl_tpu/sys/events.py`` (the reference's PETSc
event-log system, ``FspSolverMultiSinks.cpp:283-301`` and
``ReduceComponentTiming`` at ``:467-516``), with the same phase names.
The port runs in one process, so :meth:`EventLog.reduce` returns
(min, max, sum) of the local time with all three equal.

:meth:`EventLog.timed` is the one span.  While ``torch.profiler`` runs,
each span is also a ``phase.<name>`` range on the profiler's timeline,
whose clock the device trace shares.  Code below the driver (the
integrators, GMRES, the operators) reaches the solver's log through
:func:`span` (and counts through :func:`count`), which record into the
log made :func:`active` around the driver's calls, and do nothing where
none is.  Host-side counting that a CUDA graph's replays must repeat goes
through :func:`tally`: inside :func:`deferred` (a capture) it is kept for
the replays instead of run.
"""
from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
from torch.autograd import profiler as _profiler

# Canonical event names, mirroring the phases the reference registers.
EVT_SETUP = "Setup"
EVT_PARTITION = "StatePartitioning"
EVT_MATGEN = "MatrixGeneration"
EVT_ODESOLVE = "ODESolve"
EVT_RHS = "RHSEvaluation"
EVT_SCATTER = "SolutionScatter"
EVT_TOTAL = "Solving"
#: integrator step counts (accepted, rejected), summed over epochs
EVT_STEPS = "ODESteps"
EVT_REJECTED = "ODEStepsRejected"
#: the box's rebuilds in a new axis order (count and time; port only)
EVT_REORDER = "BoxReorder"
# Spans below the driver (port only), recorded through :func:`span`.
#: one operator application (a batched one counts once)
EVT_ACTION = "OperatorAction"
#: the model's time coefficients c(t), where the caller holds none
EVT_COEFFS = "ModelCoefficients"
#: one GMRES solve
EVT_GMRES = "GMRES"
#: one Arnoldi iteration's Gram-Schmidt and norm (not its host sync)
EVT_ORTHO = "GMRESOrthogonalize"
#: one capture of an Arnoldi iteration as a CUDA graph, and one replay
EVT_GMRES_CAPTURE = "GMRESCapture"
EVT_GMRES_REPLAY = "GMRESReplay"
#: counters: one GMRES restart cycle opened from the zero vector, without
#: a matvec; one BDF step attempt whose arithmetic took the fused passes
EVT_GMRES_ZERO_GUESS = "GMRESZeroGuess"
EVT_BDF_FUSED = "BDFFusedStep"
#: prefix of the blocking device-to-host reads, one name per site
#: (:func:`~..ops.vecops.to_host`)
EVT_HOST_SYNC = "HostSync."
#: one stacked forward-sensitivity action (p and every s_j), and its
#: derivative part inside it (:class:`~..ops.sens_operator.SensOperator`)
EVT_SENS_ACTION = "SensAction"
EVT_SENS_DERIVATIVE = "SensDerivative"
#: counters of the stacked actions: (1 + Np) x the states, and (1 + Np) x
#: the constraints, each action covered
EVT_SENS_STATES = "SensActionStates"
EVT_SENS_SINKS = "SensActionSinks"


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


def profiler_enabled() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) is recording:
    the flag its ``__enter__`` sets, one attribute read."""
    return _profiler._is_profiler_enabled


class _Timed:
    """The context of one :meth:`EventLog.timed` span."""
    __slots__ = ("records", "name", "t0", "range")

    def __init__(self, records: Dict[str, "EventRecord"], name: str):
        self.records, self.name = records, name

    def __enter__(self):
        if profiler_enabled():
            self.range = _profiler.record_function("phase." + self.name)
            self.range.__enter__()
        else:
            self.range = None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        rec = self.records.get(self.name)
        if rec is None:
            rec = self.records[self.name] = EventRecord()
        rec.count += 1
        rec.total_s += dt
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class EventLog:
    """Named wall-clock phase timers with nesting support."""

    def __init__(self):
        self.events: Dict[str, EventRecord] = {}

    def timed(self, name: str):
        """A context that counts one entry of ``name`` and adds its wall
        seconds; while a profiler records, also a ``phase.<name>``
        range."""
        return _Timed(self.events, name)

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


#: the log :func:`span` records into (None: spans do nothing)
_ACTIVE: Optional[EventLog] = None
_NO_SPAN = nullcontext()


@contextmanager
def active(log: Optional[EventLog]):
    """Within the block, :func:`span` records into ``log`` (None: into
    nothing)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, log
    try:
        yield log
    finally:
        _ACTIVE = prev


def span(name: str):
    """``timed(name)`` of the active log, or a shared no-op context where
    no log is active."""
    log = _ACTIVE
    return _NO_SPAN if log is None else log.timed(name)


def count(name: str, n: int) -> None:
    """``add_count(name, n)`` of the active log; nothing where none is."""
    log = _ACTIVE
    if log is not None:
        log.add_count(name, n)


#: the functions :func:`tally` keeps inside :func:`deferred` (None: it
#: runs them)
_DEFERRED: Optional[list] = None


@contextmanager
def deferred():
    """Within the block, :func:`tally` keeps its functions in the list
    this yields instead of running them: the host-side counts of code
    captured in a CUDA graph, which each replay of the graph runs."""
    global _DEFERRED
    prev, _DEFERRED = _DEFERRED, []
    try:
        yield _DEFERRED
    finally:
        _DEFERRED = prev


def tally(fn) -> None:
    """Run ``fn`` (a count, such as :func:`count`'s, made when it runs),
    or keep it for the replays inside :func:`deferred`."""
    if _DEFERRED is None:
        fn()
    else:
        _DEFERRED.append(fn)
