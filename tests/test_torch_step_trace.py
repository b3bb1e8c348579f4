"""The port's per-accepted-step trace and RHS-evaluation event
(counterpart of ``tests/test_step_trace.py``; reference per-step perf
logging, OdeSolverBase.cpp:105-132): each integrator records (t, h,
m/order/stages) per accepted step, the FSP solver drains them into
``StepTrace`` and counts the RHS evaluations and their FLOPs in the
event log.  The port's trace is held to the reference package's on the
same solve: the same steps, times within 1e-9 relative (Krylov, RK)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import pacmensl_tpu as pm  # noqa: E402
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.sys.events import EVT_RHS, StepTrace  # noqa: E402


def _solve(pkg, odes, **kw):
    b = pkg.models.poisson(2.0)
    s = pkg.FspSolverMultiSinks(backend="ell", odes_type=odes, **kw)
    s.set_model(b.model)
    s.set_initial_bounds([10])
    s.set_expansion_factors([0.5])
    s.set_initial_distribution(b.x0, b.p0)
    s.solve(5.0, 1e-4)
    return s


@pytest.mark.parametrize("odes", ["krylov", "cvode", "petsc"])
def test_per_step_trace_and_rhs_event(odes):
    s = _solve(pt, odes, device="cpu")
    tr = s.step_trace
    n_epochs = s.events.events["ODESolve"].count
    # one trace row per accepted step: strictly more rows than epochs
    assert tr.n_steps > n_epochs
    t = np.asarray(tr.model_time)
    h = np.asarray(tr.step_h)
    aux = np.asarray(tr.aux)
    # model time is nondecreasing within the solve and ends at t_final
    assert (np.diff(t) >= -1e-12).all()
    assert t[-1] == pytest.approx(5.0, rel=1e-9)
    assert (h > 0).all()
    # method detail: Krylov m in [m_min, m_max]; BDF order in [1, 5];
    # RK 7 stages
    if odes == "krylov":
        assert ((aux >= 1) & (aux <= 60)).all()
    elif odes == "cvode":
        assert ((aux >= 1) & (aux <= 5)).all()
    else:
        assert (aux == 7).all()
    assert len(tr.n_eqs) == len(tr.model_time) == len(tr.step_h) \
        == len(tr.wall_time)
    rhs = s.events.events[EVT_RHS]
    assert rhs.count > 0 and rhs.flops > 0
    # every accepted step costs at least one matvec
    assert rhs.count >= tr.n_steps
    # the reference package's trace of the same solve.  Its solver
    # restarts BDF at each dispatch of a matvec budget, so BDF's steps
    # differ: only the end is compared there
    ref = _solve(pm, odes).step_trace
    if odes == "cvode":
        assert ref.model_time[-1] == pytest.approx(t[-1], rel=1e-12)
        return
    assert tr.n_steps == ref.n_steps
    np.testing.assert_allclose(t, np.asarray(ref.model_time), rtol=1e-9)
    np.testing.assert_array_equal(aux, np.asarray(ref.aux))
    np.testing.assert_array_equal(np.asarray(tr.n_eqs),
                                  np.asarray(ref.n_eqs))


def test_trace_ring_overflow_reconstructs_chronology():
    """An epoch longer than the ring: the drained trace stays
    chronological and the dropped prefix is counted."""
    def mv(t, y):
        return pt.FspVector(p=-0.1 * y.p, sinks=torch.zeros_like(y.sinks))

    y0 = pt.FspVector(p=torch.ones(8, dtype=torch.float64),
                      sinks=torch.zeros(1, dtype=torch.float64))
    res = pt.RKSolver(mv, trace_cap=16).solve(y0, 0.0, 50.0)
    n_steps = int(res.stats.n_steps)
    assert n_steps > 16, "the test needs an epoch longer than the ring"
    st = StepTrace()
    st.record_epoch(n_steps, res.trace.arrays(), y0.p.numel())
    assert st.n_steps == 16
    assert st.truncated == n_steps - 16
    assert (np.diff(st.model_time) > 0).all()
    # the ring's last entries are the epoch's last steps
    assert st.model_time[-1] == pytest.approx(50.0, rel=1e-12)
