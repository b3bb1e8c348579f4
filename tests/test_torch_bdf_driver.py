"""The port's driver on the time-varying path: ``odes_type="auto"`` picks
BDF for time-varying models (with the reference package's warning for
KRYLOV), the BDF vector budget, hog1p_3d to t = 30 against the reference
package's ``FspSolverMultiSinks(backend="box", odes_type="cvode")``, and a
BDF restart from a checkpoint the reference package wrote."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.fsp.distribution import (  # noqa: E402
    DiscreteDistribution as JDist)
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.interop import distribution_from_reference  # noqa: E402
from pacmensl_tpu_torch.solvers.base import ODESolverType  # noqa: E402


class _OneDispatch(pm.FspSolverMultiSinks):
    """The reference driver with one integrator dispatch per epoch: its
    matvec budget per dispatch (a remote-TPU workaround the port does not
    have) would restart BDF mid-epoch at order 1."""

    def _make_ode_solver(self, *args):
        solver = super()._make_ode_solver(*args)
        inner = solver.solve

        def solve(*a, mv_budget=None, **kw):
            return inner(*a, mv_budget=1 << 30, **kw)
        solver.solve = solve
        return solver


def _hog3(pkg, cls=None, odes_type="auto", **kw):
    b = pkg.models.hog1p_3d()
    s = (cls or pkg.FspSolverMultiSinks)(odes_type=odes_type, **kw)
    s.set_model(b.model)
    s.set_constraint_functions(b.constraint)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors(b.expansion_factors)
    s.set_initial_distribution(b.x0, b.p0)
    return s


def _by_state(d):
    order = np.lexsort(d.states.T[::-1])
    return d.states[order], d.p[order]


def test_auto_integrator_selection():
    """tests/test_krylov_tv.py:48-64 on the port."""
    tv_model = pt.models.hog1p_3d().model
    ti_model = pt.models.toggle().model
    s = pt.FspSolverMultiSinks(device="cpu")
    assert s.odes_type == "auto"
    s.set_model(tv_model)
    assert s._resolve_odes_type() == ODESolverType.CVODE
    s.set_model(ti_model)
    assert s._resolve_odes_type() == ODESolverType.KRYLOV

    s2 = pt.FspSolverMultiSinks(odes_type="krylov", device="cpu")
    s2.set_model(tv_model)
    with pytest.warns(RuntimeWarning, match="time-varying"):
        s2._resolve_odes_type()
    s3 = pt.FspSolverMultiSinks(odes_type="cvode", device="cpu")
    s3.set_model(ti_model)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert s3._resolve_odes_type() == ODESolverType.CVODE


def test_bdf_vector_budget():
    """A time-varying model's box budget counts BDF's vectors, the
    reference package's formula, not Krylov's m_max + 2."""
    kry = _hog3(pt, odes_type="krylov", device="cpu")
    bdf = _hog3(pt, device="cpu")
    restart = pt.BdfSolver.__init__.__kwdefaults__["gmres_restart"]
    assert restart == 16
    assert bdf._box_elem_budget() == pytest.approx(
        8.0e9 / ((restart + 1 + 8 + 11) * 8))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # KRYLOV on tv
        kry_budget = kry._box_elem_budget()
    assert kry_budget == pytest.approx(8.0e9 / ((60 + 2) * 8))
    assert bdf._box_elem_budget() != kry_budget
    ref = _hog3(pm, backend="box")
    assert bdf._box_elem_budget() == pytest.approx(ref._box_elem_budget())


def test_hog1p_3d_matches_reference():
    """hog1p_3d to t = 30 with fsp_tol = 1e-4: the same 350 states and
    bounds as the reference package's box backend with BDF, in the same
    rows.  Both lay the box out in the same axis order ([1, 0, 2]: the
    gene axis is not axis 0) and capacity, and take the same epochs and
    step sequences up to rounding: the two packages' reductions sum in
    other orders, so GMRES occasionally stops one iteration apart and the
    corrector differs at its 1e-10 tolerance.  Measured TV 4.97e-7 and
    sinks 4.86e-9 apart (6.97e-7 and 2.85e-9 while the port kept user
    order); the bounds below hold both."""
    js = _hog3(pm, _OneDispatch, odes_type="cvode", backend="box")
    jd = js.solve(30.0, 1.0e-4)
    ts = _hog3(pt, device="cpu", backend="box")
    td = ts.solve(30.0, 1.0e-4)
    assert isinstance(ts._ode_solver, pt.BdfSolver)
    assert ts._operator.synth_mask
    assert td.num_states == jd.num_states == 350
    np.testing.assert_array_equal(td.bounds, jd.bounds)
    assert ts.axis_orders_ == [(None, [1, 0, 2])]
    assert tuple(ts._space.shape) == tuple(js._space.shape)
    np.testing.assert_array_equal(td.states, jd.states)
    jst, jp = _by_state(jd)
    tst, tp = _by_state(td)
    np.testing.assert_array_equal(tst, jst)
    assert 0.5 * np.abs(tp - jp).sum() <= 1.0e-6
    np.testing.assert_allclose(td.sinks, jd.sinks, rtol=0, atol=5.0e-9)
    assert td.sum() >= 1.0 - 1.0e-4
    assert ts.events.events["ODESolve"].count == \
        js.events.events["ODESolve"].count == 6


def test_bdf_restart_from_reference_checkpoint(tmp_path):
    """The reference package solves hog1p_3d to t1 with BDF and saves; the
    port loads the checkpoint and continues to t2, as the reference does
    from the same file."""
    path = str(tmp_path / "t1.npz")
    _hog3(pm, _OneDispatch, odes_type="cvode",
          backend="box").solve(2.0, 1.0e-4).save(path)

    js = _hog3(pm, _OneDispatch, odes_type="cvode", backend="box")
    js.set_initial_distribution(JDist.load(path))
    jd = js.solve(4.0, 1.0e-4, t_init=2.0)

    ts = _hog3(pt, device="cpu", backend="box")
    ts.set_initial_distribution(distribution_from_reference(path))
    td = ts.solve(4.0, 1.0e-4, t_init=2.0)

    assert isinstance(ts._ode_solver, pt.BdfSolver)
    jst, jp = _by_state(jd)
    tst, tp = _by_state(td)
    np.testing.assert_array_equal(tst, jst)
    np.testing.assert_array_equal(td.bounds, jd.bounds)
    assert 0.5 * np.abs(tp - jp).sum() <= 1e-9
    assert td.sum() >= 1.0 - 1.0e-4
