"""The port's transient FSP driver: the Poisson oracle, the repressilator
slice at a small time against the reference package's box backend with
the Krylov integrator, restarts across the two packages' checkpoints, and
the driver's error paths."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.fsp.distribution import (  # noqa: E402
    DiscreteDistribution as JDist)
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.interop import (  # noqa: E402
    distribution_from_reference, distribution_to_reference)


def _poisson_pmf(k, lam):
    return np.exp(k * math.log(lam) - lam
                  - np.array([math.lgamma(v + 1.0) for v in k]))


def _setup_poisson(pkg, **kw):
    b = pkg.models.poisson(2.0)
    s = pkg.FspSolverMultiSinks(odes_type="krylov", **kw)
    s.set_model(b.model)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors([0.5])
    s.set_initial_distribution(b.x0, b.p0)
    return s


def _by_state(d):
    """(states, p) sorted by state: the reference package may reorder the
    box axes, so distributions are compared by state identity."""
    order = np.lexsort(d.states.T[::-1])
    return d.states[order], d.p[order]


def test_poisson_oracle():
    s = _setup_poisson(pt, device="cpu")
    d = s.solve(10.0, 1.0e-6)
    assert np.abs(d.p - _poisson_pmf(d.states[:, 0], 20.0)).sum() <= 1e-6
    assert d.bounds[0] > 20
    ev = s.get_event_log().events
    for name in ("Solving", "ODESolve", "MatrixGeneration", "RHSEvaluation"):
        assert name in ev
    assert s.reduce_component_timing()["Solving"][2] > 0


def test_solve_tspan():
    s = _setup_poisson(pt, device="cpu")
    tspan = [1.0, 2.5, 4.0]
    dists = s.solve_tspan(tspan, 1.0e-6)
    for t, d in zip(tspan, dists):
        assert d.t == pytest.approx(t)
        assert np.abs(d.p - _poisson_pmf(d.states[:, 0], 2.0 * t)
                      ).sum() <= 1e-6


def test_repressilator_slice_matches_reference():
    """Repressilator with its custom constraints, t = 0.5, fsp_tol = 1e-4:
    the same state set, bounds, epochs and RHS evaluations as the
    reference package's box backend, total variation <= 1e-9."""
    def run(pkg, **kw):
        b = pkg.models.repressilator()
        s = pkg.FspSolverMultiSinks(backend="box", odes_type="krylov", **kw)
        s.set_model(b.model)
        s.set_constraint_functions(b.constraint)
        s.set_initial_bounds(b.bounds)
        s.set_expansion_factors(b.expansion_factors)
        s.set_initial_distribution(b.x0, b.p0)
        return s, s.solve(0.5, 1.0e-4)

    js, jd = run(pm)
    ts, td = run(pt, device="cpu")
    assert td.num_states == jd.num_states == 2770
    np.testing.assert_array_equal(td.bounds, jd.bounds)
    jst, jp = _by_state(jd)
    tst, tp = _by_state(td)
    np.testing.assert_array_equal(tst, jst)
    assert 0.5 * np.abs(tp - jp).sum() <= 1e-9
    np.testing.assert_allclose(td.sinks, jd.sinks, rtol=0, atol=1e-10)
    assert td.sum() >= 1.0 - 1.0e-4
    for name in ("ODESolve", "RHSEvaluation"):
        assert ts.events.events[name].count == js.events.events[name].count


def test_restart_from_reference_checkpoint(tmp_path):
    """The reference package solves to t1 and saves; the port loads the
    checkpoint and continues to t2, as the reference package does."""
    path = str(tmp_path / "t1.npz")
    _setup_poisson(pm, backend="box").solve(1.0, 1.0e-6).save(path)

    js = _setup_poisson(pm, backend="box")
    js.set_initial_distribution(JDist.load(path))
    jd = js.solve(2.0, 1.0e-6, t_init=1.0)

    ts = _setup_poisson(pt, device="cpu")
    ts.set_initial_distribution(distribution_from_reference(path))
    td = ts.solve(2.0, 1.0e-6, t_init=1.0)

    jst, jp = _by_state(jd)
    tst, tp = _by_state(td)
    np.testing.assert_array_equal(tst, jst)
    assert 0.5 * np.abs(tp - jp).sum() <= 1e-9
    assert np.abs(td.p - _poisson_pmf(td.states[:, 0], 4.0)).sum() <= 2e-6


def test_port_checkpoint_loads_in_reference(tmp_path):
    d = _setup_poisson(pt, device="cpu").solve(1.0, 1.0e-6)
    path = str(tmp_path / "port.npz")
    fields = distribution_to_reference(d, path)
    for loaded in (JDist.load(path), JDist(**fields)):
        assert loaded.t == d.t
        np.testing.assert_array_equal(loaded.states, d.states)
        np.testing.assert_array_equal(loaded.p, d.p)
        np.testing.assert_array_equal(loaded.bounds, d.bounds)
        np.testing.assert_array_equal(loaded.sinks, d.sinks)
    back = distribution_from_reference(JDist.load(path))
    np.testing.assert_array_equal(back.p, d.p)


def test_misuse_detection():
    s = pt.FspSolverMultiSinks(device="cpu")
    with pytest.raises(pt.SetupError):
        s.set_up()
    b = pt.models.poisson(2.0)
    s.set_model(b.model)
    with pytest.raises(pt.SetupError):
        s.set_up()              # bounds missing
    s.set_initial_bounds(b.bounds)
    with pytest.raises(pt.SetupError):
        s.set_up()              # initial distribution missing
    with pytest.raises(pt.SetupError):
        s.set_initial_distribution(b.x0, None)


def test_unported_paths_raise():
    with pytest.raises(pt.SetupError, match="A9"):
        pt.FspSolverMultiSinks(backend="ell", device="cpu")
    b = pt.models.hog1p_3d()            # time-varying: "auto" picks BDF
    s = pt.FspSolverMultiSinks(device="cpu")
    s.set_model(b.model)
    s.set_constraints(b.constraint, b.bounds, b.expansion_factors)
    s.set_initial_distribution(b.x0, b.p0)
    with pytest.raises(pt.SetupError, match="A7"):
        s.set_up()


def test_leaving_the_box_backend_raises():
    """Where the reference package would migrate to the compressed
    backend, the port stops with an error naming the ROADMAP item."""
    s = _setup_poisson(pt, device="cpu")
    s._box_elem_budget = lambda: 10.0
    with pytest.raises(pt.StateSpaceError, match="A9"):
        s.solve(10.0, 1.0e-6)
