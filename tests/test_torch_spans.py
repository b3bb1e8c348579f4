"""The port's spans and host-sync counters below the driver: the counts
the loop's structure implies (operator actions, GMRES, the
``HostSync.<site>`` reads), their ``phase.<name>`` ranges on
``torch.profiler``'s timeline and how they nest, the profiler check that
keeps the ranges off when no profiler runs, ``-fsp_log_events 0``, and a
solution bitwise the same with and without the spans."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.ops import vecops as vo  # noqa: E402
from pacmensl_tpu_torch.sys import events  # noqa: E402

#: hog1p_3d with BDF: 6 expansion epochs to t = 10 at this tolerance
T_FINAL, FSP_TOL = 10.0, 1e-6
NEW = ("OperatorAction", "ModelCoefficients", "GMRES", "GMRESOrthogonalize")


def _hog3(log_events=True, backend=None):
    b = pt.models.hog1p_3d()
    kw = {} if backend is None else {"backend": backend}
    s = pt.FspSolverMultiSinks(device="cpu", **kw)
    if not log_events:
        s.set_from_options(pt.Options.from_argv(["-fsp_log_events", "0"]))
    s.set_model(b.model)
    s.set_constraint_functions(b.constraint)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors(b.expansion_factors)
    s.set_initial_distribution(b.x0, b.p0)
    return s


@pytest.fixture(scope="module")
def solved():
    s = _hog3()
    d = s.solve(T_FINAL, FSP_TOL)
    return s, d, {k: v.count for k, v in s.get_event_log().events.items()}


def test_actions_are_rhs_evaluations_plus_gmres_cycles(solved):
    _, _, n = solved
    assert n["ODESolve"] > 1                      # the solve expanded
    # each GMRES solve's first cycle opens from the zero vector without a
    # matvec; a later cycle's residual is one
    restarts = n.get("HostSync.GMRESResidual", 0)
    assert n["GMRESZeroGuess"] == n["GMRES"]
    assert restarts + n["GMRESZeroGuess"] >= n["GMRES"]
    assert n["OperatorAction"] == n["RHSEvaluation"] + restarts
    # a time-varying model: every action computes its c(t)
    assert n["ModelCoefficients"] == n["OperatorAction"]


def test_host_syncs_follow_the_loop(solved):
    _, _, n = solved
    epochs = n["ODESolve"]
    stops = epochs - 1                # every epoch but the last one stops
    attempts = n["ODESteps"] + n["ODEStepsRejected"] + stops
    accepted = n["ODESteps"] + stops
    # RHS evaluations: the first step's once an epoch, then per attempt
    # the corrector's right-hand side and one per Arnoldi iteration
    arnoldi = n["RHSEvaluation"] - epochs - attempts
    want = {"BDFStartNorm": epochs, "BDFErrorNorm": attempts,
            "GMRESNorm": attempts, "GMRESColumn": arnoldi,
            "StopCheck": accepted, "EpochSinks": epochs}
    got = {k[len("HostSync."):]: v for k, v in n.items()
           if k.startswith("HostSync.")}
    for site, count in want.items():
        assert got[site] == count, site
    assert n["GMRES"] == attempts
    assert n["GMRESOrthogonalize"] == arnoldi
    # the initial vector sets the sinks, so the first epoch's stop-check
    # preparation reads none from the card
    assert "InitialSinks" not in got
    order_changes = got["BDFOrderNorms"]
    assert 0 < order_changes <= accepted
    assert sum(got.values()) == (sum(want.values()) + order_changes
                                 + got.get("GMRESResidual", 0))


def _phase_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("phase."):
        p = p.cpu_parent
    return None if p is None else p.name


def test_profiler_ranges_nest():
    from torch.profiler import ProfilerActivity, profile
    s = _hog3()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.solve(2.0, 1e-4)
    parents = {}
    for e in prof.events():
        if e.name.startswith("phase."):
            parents.setdefault(e.name, set()).add(_phase_parent(e))
    for name in NEW + ("HostSync.GMRESColumn", "HostSync.StopCheck"):
        assert "phase." + name in parents, name
    assert parents["phase.GMRESOrthogonalize"] == {"phase.GMRES"}
    assert parents["phase.HostSync.GMRESColumn"] == {"phase.GMRES"}
    assert parents["phase.ModelCoefficients"] == {"phase.OperatorAction"}
    # Arnoldi and residual matvecs inside GMRES, the corrector's
    # right-hand side and the first step's outside it
    assert parents["phase.OperatorAction"] == {"phase.GMRES",
                                               "phase.ODESolve"}
    assert parents["phase.ODESolve"] == {"phase.Solving"}
    n = s.get_event_log().events
    assert sum(e.name == "phase.OperatorAction" for e in prof.events()) \
        == n["OperatorAction"].count


def test_profiler_check():
    from torch.profiler import ProfilerActivity, profile
    assert events.profiler_enabled() is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert events.profiler_enabled() is True
    assert events.profiler_enabled() is False


def test_no_record_function_without_profiler(monkeypatch, solved):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(events._profiler, "record_function", refuse)
    s = _hog3()
    s.solve(2.0, 1e-4)
    assert s.get_event_log().events["OperatorAction"].count > 0


def test_log_events_off_records_no_span(solved):
    s = _hog3(log_events=False)
    d = s.solve(T_FINAL, FSP_TOL)
    names = set(s.get_event_log().events)
    assert not names & set(NEW)
    assert not [k for k in names if k.startswith("HostSync.")]
    assert "ODESolve" in names and "StopCheckPrep" in names
    assert events._ACTIVE is None
    # the spans only observe: the same solution, bit for bit
    _, d_on, _ = solved
    np.testing.assert_array_equal(d.states, d_on.states)
    assert np.array_equal(d.p, d_on.p) and np.array_equal(d.sinks,
                                                          d_on.sinks)


@pytest.mark.parametrize("backend", ["box", "ell"])
def test_batched_action_is_one_action(backend):
    s = _hog3(backend=backend).set_up()
    op = s._operator
    P = torch.rand((3, op.local_n), dtype=torch.float64)
    log = events.EventLog()
    with events.active(log):
        dp, sinks = op.action_batched(1.0, P)
        single = op.action(1.0, vo.FspVector(p=P[1], sinks=None))
    assert log.events["OperatorAction"].count == 2
    # the box: once for the one t; ELL: once per row and call
    assert log.events["ModelCoefficients"].count == (
        1 if backend == "box" else 4)
    torch.testing.assert_close(dp[1], single.p, rtol=0, atol=0)


def test_span_without_active_log():
    assert events.span("GMRES") is events.span("OperatorAction")
    log, inner = events.EventLog(), events.EventLog()
    with events.active(log):
        with events.span("A"):
            with events.active(inner), events.span("B"):
                pass
        with events.span("A"):
            pass
    with events.span("C"):
        pass
    assert {k: v.count for k, v in log.events.items()} == {"A": 2}
    assert list(inner.events) == ["B"]
    assert events._ACTIVE is None


def test_krylov_host_syncs():
    b = pt.models.poisson(2.0)
    s = pt.FspSolverMultiSinks(odes_type="krylov", device="cpu")
    s.set_model(b.model)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors([0.5])
    s.set_initial_distribution(b.x0, b.p0)
    s.solve(2.0, 1e-6)
    n = {k: v.count for k, v in s.get_event_log().events.items()}
    # every Krylov matvec is an RHS evaluation; each step syncs beta once
    # and the Hessenberg once, each Arnoldi vector's norm once
    assert n["OperatorAction"] == n["RHSEvaluation"]
    steps = n["ODESteps"]
    assert n["HostSync.KrylovBeta"] == steps
    assert n["HostSync.KrylovHessenberg"] == steps
    assert n["HostSync.KrylovNorm"] <= n["RHSEvaluation"]
    assert n["HostSync.EpochSinks"] == n["ODESolve"]
