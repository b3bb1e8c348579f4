"""The port's stationary solver on the CPU (``tests/test_stationary.py``
on the port): the birth-death law against Poisson(10) on both backends,
the telegraph model's mean, time-varying models rejected, the same
states and pi as the reference package's stationary solve within 1e-10,
and ``precision="df64"`` giving the float64 result.
"""
import numpy as np
import pytest
from scipy.stats import poisson as poisson_law

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.stationary.solver import (  # noqa: E402
    StationaryFspSolverMultiSinks as JStationary)
import pacmensl_tpu_torch as pt  # noqa: E402


def _birth_death(cls, backend, **kw):
    b = (pt if cls is pt.StationaryFspSolverMultiSinks
         else pm).models.birth_death(birth=1.0, death=0.1)
    s = cls(backend=backend, **kw)
    s.set_model(b.model)
    s.set_initial_bounds([10])
    s.set_expansion_factors([0.5])
    s.set_initial_distribution(b.x0, b.p0)
    return s


@pytest.mark.parametrize("backend", ["box", "ell"])
def test_birth_death_stationary_is_poisson(backend):
    s = _birth_death(pt.StationaryFspSolverMultiSinks, backend,
                     device="cpu")
    d = s.solve(1.0e-7)
    assert s._backend_used == backend
    pdf = poisson_law.pmf(d.states[:, 0], 10.0)
    pdf /= pdf.sum()        # the truncated, normalized law
    assert np.abs(d.p - pdf).sum() < 1e-6
    assert d.bounds[0] > 10             # expansion ran
    assert len(s.rounds_) > 1 and s.last_raw_res_norm_ < 1e-9
    assert (s.sinks_ <= 1.0e-7).all()
    assert np.isnan(d.t)


@pytest.mark.parametrize("backend", ["box", "ell"])
def test_telegraph_stationary_mean(backend):
    """Bursting gene: mean mRNA = (kr / gamma) k01 / (k01 + k10)."""
    k01, k10, kr, gamma = 0.1, 0.2, 5.0, 1.0
    b = pt.models.telegraph(k01, k10, kr, gamma)
    s = pt.StationaryFspSolverMultiSinks(backend=backend, device="cpu")
    s.set_model(b.model.base_model())
    s.set_initial_bounds([1, 1, 15])
    s.set_expansion_factors([0.0, 0.0, 0.5])
    s.set_initial_distribution(b.x0, b.p0)
    d = s.solve(1.0e-8)
    assert d.mean(2) == pytest.approx((kr / gamma) * k01 / (k01 + k10),
                                      rel=1e-3)
    assert d.sum() == pytest.approx(1.0, abs=1e-12)


def test_stationary_rejects_time_varying():
    s = pt.StationaryFspSolverMultiSinks(device="cpu")
    with pytest.raises(pt.SetupError):
        s.set_model(pt.models.hog1p_5d().model)
    with pytest.raises(pt.SetupError):
        pt.StationaryFspSolverMultiSinks(device="cpu", precision="f32")


@pytest.mark.parametrize("backend", ["box", "ell"])
def test_matches_the_reference_package(backend):
    dj = _birth_death(JStationary, backend).solve(1.0e-7)
    dt = _birth_death(pt.StationaryFspSolverMultiSinks, backend,
                      device="cpu").solve(1.0e-7)
    np.testing.assert_array_equal(dt.states, dj.states)
    np.testing.assert_array_equal(dt.bounds, dj.bounds)
    np.testing.assert_allclose(dt.p, dj.p, rtol=0, atol=1e-10)


def test_df64_is_the_float64_solve():
    """``precision="df64"`` names the reference's double-float engine;
    in the port it is the native float64 solve, and meets the oracle of
    ``tests/test_stationary.py::test_df64_stationary_beats_f32_floor``
    (L1 below 1e-8 at sfsp_tol 1e-10, raw residual below 1e-10)."""
    out = {}
    for prec in ("native", "df64"):
        s = _birth_death(pt.StationaryFspSolverMultiSinks, "box",
                         device="cpu", precision=prec)
        out[prec] = s.solve(1.0e-10)
        assert s.last_raw_res_norm_ < 1e-10
    np.testing.assert_array_equal(out["df64"].p, out["native"].p)
    d = out["df64"]
    pdf = poisson_law.pmf(d.states[:, 0], 10.0)
    assert np.abs(d.p - pdf / pdf.sum()).sum() < 1e-8
