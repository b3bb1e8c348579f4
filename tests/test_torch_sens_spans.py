"""The stacked sensitivity action's spans and counters: one
``SensAction`` per ``SensOperator.action`` with one ``SensDerivative``
inside it (also as ``phase.<name>`` ranges under ``torch.profiler``), the
counters ``SensActionStates`` and ``SensActionSinks`` equal to
sum (1 + Np) n and sum (1 + Np) n_c over the actions, nothing recorded
without an active log or with ``-fsp_log_events 0``, and the solution
bitwise the same either way; c(t) computed once for each new ``t`` (one
``ModelCoefficients`` span, not one per action).  Over two gloo ranks:
``tests/test_torch_halo_ell.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.ops.sens_operator import SensOperator  # noqa: E402
from pacmensl_tpu_torch.sys import events  # noqa: E402

#: (bundle, backend, t_final): derivative propensities (telegraph, four
#: parameters) and a derivative time coefficient (poisson_sens)
CASES = [("telegraph", "box", 1.0), ("telegraph", "ell", 1.0),
         ("poisson_sens", "box", 1.0)]
SPANS = ("SensAction", "SensDerivative", "SensActionStates",
         "SensActionSinks")


def _solver(name, backend, log_events=True):
    b = getattr(pt.models, name)()
    s = pt.SensFspSolverMultiSinks(backend=backend, device="cpu")
    if not log_events:
        s.set_from_options(pt.Options.from_argv(["-fsp_log_events", "0"]))
    s.set_model(b.model)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors(np.maximum(b.expansion_factors, 0.5))
    s.set_initial_distribution(b.x0, b.p0)
    return s


def _counted(monkeypatch):
    """Wrap ``SensOperator.action``: each call's (1 + Np) n and
    (1 + Np) n_c."""
    calls = []
    orig = SensOperator.action

    def action(self, t, y, out=None):
        m = 1 + self.n_par
        calls.append((m * self.space.num_states, m * self.num_constraints))
        return orig(self, t, y, out=out)
    monkeypatch.setattr(SensOperator, "action", action)
    return calls


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def solved(request):
    name, backend, t_final = request.param
    mp = pytest.MonkeyPatch()
    try:
        calls = _counted(mp)
        s = _solver(name, backend)
        d = s.solve(t_final, 1e-6)
    finally:
        mp.undo()
    return request.param, s, d, calls


def test_one_span_each_per_action(solved):
    _, s, _, calls = solved
    ev = s.get_event_log().events
    assert len(calls) > 10 and ev["ODESolve"].count > 1   # it expanded
    assert ev["SensAction"].count == len(calls)
    assert ev["SensDerivative"].count == len(calls)
    # the derivative part lies inside the whole action
    assert 0 < ev["SensDerivative"].total_s < ev["SensAction"].total_s


def test_counters_are_the_vector_states_and_sinks(solved):
    _, s, _, calls = solved
    ev = s.get_event_log().events
    assert ev["SensActionStates"].count == sum(n for n, _ in calls)
    assert ev["SensActionSinks"].count == sum(k for _, k in calls)
    assert len({n for n, _ in calls}) > 1   # the state count grew


def test_log_off_records_nothing_and_changes_nothing(solved):
    (name, backend, t_final), _, d_on, _ = solved
    s = _solver(name, backend, log_events=False)
    d = s.solve(t_final, 1e-6)
    assert not set(SPANS) & set(s.get_event_log().events)
    assert events._ACTIVE is None
    np.testing.assert_array_equal(d.states, d_on.states)
    assert np.array_equal(d.p, d_on.p) and np.array_equal(d.dp, d_on.dp)
    assert np.array_equal(d.sinks, d_on.sinks)


def test_action_without_active_log():
    s = _solver("telegraph", "box").set_up()
    op, y = s._operator, s._y
    log = events.EventLog()
    out = op.action(0.5, y)
    with events.active(log):
        logged = op.action(0.5, y)
    assert torch.equal(out.p, logged.p) and torch.equal(out.sinks,
                                                        logged.sinks)
    m = 1 + op.n_par
    n = {k: v.count for k, v in log.events.items()}
    assert n["SensAction"] == n["SensDerivative"] == 1
    assert n["SensActionStates"] == m * s.num_states
    assert n["SensActionSinks"] == m * op.num_constraints
    assert events._ACTIVE is None


def test_profiler_ranges_nest():
    from torch.profiler import ProfilerActivity, profile
    s = _solver("poisson_sens", "box")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.solve(0.3, 1e-6)
    parent = {}
    for e in prof.events():
        if e.name in ("phase.SensDerivative", "phase.OperatorAction"):
            p = e.cpu_parent
            while p is not None and not p.name.startswith("phase."):
                p = p.cpu_parent
            parent.setdefault(e.name, set()).add(p.name)
    assert parent["phase.SensDerivative"] == {"phase.SensAction"}
    # the batched action, and the derivative operators' inside their part
    assert parent["phase.OperatorAction"] == {"phase.SensAction",
                                              "phase.SensDerivative"}
    n = s.get_event_log().events["SensAction"].count
    assert sum(e.name == "phase.SensAction" for e in prof.events()) == n


@pytest.mark.parametrize("name,backend,t_final", [
    ("hog1p_3d_sens", "box", 2.0), ("poisson_sens", "box", 1.0),
    ("telegraph", "ell", 1.0)])
def test_coefficients_once_for_each_new_t(name, backend, t_final,
                                          monkeypatch):
    """A sensitivity solve makes one ``ModelCoefficients`` span each time
    an operator is applied or staged at another ``t`` than its last (the
    model's c(t) and every derivative coefficient together), not one per
    ``SensAction``: a BDF step's right-hand side and GMRES matvecs share
    one ``t``."""
    ops, last, new_t = [], {}, [0]

    def seen(op, t):
        if id(op) not in last:
            ops.append(op)          # kept alive: its id stays its own
        if last.get(id(op)) != t:
            new_t[0] += 1
        last[id(op)] = t
    action, stage = SensOperator.action, SensOperator.stage

    def seen_action(self, t, y, out=None):
        seen(self, t)
        return action(self, t, y, out=out)

    def seen_stage(self, t):
        seen(self, t)
        return stage(self, t)
    monkeypatch.setattr(SensOperator, "action", seen_action)
    monkeypatch.setattr(SensOperator, "stage", seen_stage)
    b = getattr(pt.models, name)()
    s = pt.SensFspSolverMultiSinks(backend=backend, device="cpu")
    s.set_model(b.model)
    if b.constraint is not None:
        s.set_constraint_functions(b.constraint)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors(np.maximum(b.expansion_factors, 0.5))
    s.set_initial_distribution(b.x0, b.p0)
    s.solve(t_final, 1e-6)
    ev = s.get_event_log().events
    assert len(ops) >= 1
    assert ev["ModelCoefficients"].count == new_t[0]
    # at most one c(t) an epoch's start and one a step attempt ...
    assert (ev["ModelCoefficients"].count
            <= ev["ODESolve"].count + ev["GMRES"].count)
    # ... against one action a matvec and one a GMRES cycle's start,
    # counted whether it applied the map or opened from the zero vector
    assert 3 * ev["ModelCoefficients"].count < (
        ev["SensAction"].count + ev["GMRESZeroGuess"].count)
