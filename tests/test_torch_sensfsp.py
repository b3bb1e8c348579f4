"""The port's forward-sensitivity driver on the CPU.

* The Poisson analytic oracle (the reference test_sensfsp_solver.cpp):
  dp/dlambda of Poisson(lambda t) is t (p_{n-1} - p_n); L1 of p at most
  fsp_tol and of dp at most 1e-6, under Krylov and BDF.
* Telegraph conservation at a short horizon: sum(p) >= 1 - fsp_tol and
  each sensitivity sums to 0 within 1e-6.
* Against the reference package's ``SensFspSolverMultiSinks(backend=
  "box")`` with the Krylov integrator: the same states, and p and dp by
  state within 1e-12 absolute (both integrate the same linear system with
  the same step rules; only the order of sums differs).
* The FIM, the sensitivity marginals, and ``.npz`` checkpoints read in
  both directions between the packages.
"""
import numpy as np
import pytest
from scipy.special import gammaln

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.sensfsp.sens_distribution import (  # noqa: E402
    SensDiscreteDistribution as JSensDist)
from pacmensl_tpu.sensfsp.sens_solver import (  # noqa: E402
    SensFspSolverMultiSinks as JSensSolver)
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch import interop  # noqa: E402


def _solver(bundle, ode, bounds=None, factors=None):
    s = pt.SensFspSolverMultiSinks(odes_type=ode, device="cpu")
    s.set_model(bundle.model)
    s.set_initial_bounds(bundle.bounds if bounds is None else bounds)
    s.set_expansion_factors(bundle.expansion_factors if factors is None
                            else factors)
    s.set_initial_distribution(bundle.x0, bundle.p0)
    return s


def _poisson(ode, t_final=1.0, fsp_tol=1.0e-7):
    s = _solver(pt.models.poisson_sens(2.0), ode, [5], [0.5])
    s.set_ode_tolerances(1e-8, 1e-14)
    return s.solve(t_final, fsp_tol)


@pytest.mark.filterwarnings("ignore:KRYLOV on a time-varying model")
@pytest.mark.parametrize("ode", ["cvode", "krylov"])
def test_sens_poisson_analytic(ode):
    t_final, fsp_tol, lam = 1.0, 1.0e-7, 2.0
    d = _poisson(ode, t_final, fsp_tol)
    assert isinstance(d, pt.SensDiscreteDistribution)
    nn = d.states[:, 0].astype(np.float64)
    pdf = np.exp(-lam * t_final + nn * np.log(lam * t_final)
                 - gammaln(nn + 1))
    assert np.abs(d.p - pdf).sum() <= fsp_tol
    sens = -t_final * pdf + t_final * np.concatenate([[0.0], pdf[:-1]])
    assert np.abs(d.dp[0] - sens).sum() <= 1.0e-6


def test_sens_telegraph_conservation():
    s = _solver(pt.models.telegraph(), "cvode")
    fsp_tol = 1e-8
    d = s.solve(1.0, fsp_tol)
    assert d.sum() >= 1.0 - fsp_tol
    assert d.num_parameters == 4 and np.isfinite(d.dp).all()
    for j in range(d.num_parameters):
        assert abs(d.dp[j].sum()) <= 1e-6


def _by_state(states, values):
    return {tuple(x): float(v) for x, v in zip(states, values)}


@pytest.mark.filterwarnings("ignore:KRYLOV on a time-varying model")
@pytest.mark.parametrize("name,t_final,fsp_tol", [
    ("poisson_sens", 1.0, 1e-7), ("telegraph", 1.0, 1e-6)])
def test_sens_solve_matches_the_reference_package(name, t_final, fsp_tol):
    out = {}
    for pkg, make in (("ref", lambda b: JSensSolver(backend="box",
                                                     odes_type="krylov")),
                      ("port", lambda b: pt.SensFspSolverMultiSinks(
                          odes_type="krylov", device="cpu"))):
        mod = pm if pkg == "ref" else pt
        b = getattr(mod.models, name)()
        s = make(b)
        s.set_model(b.model)
        s.set_initial_bounds(b.bounds)
        s.set_expansion_factors(b.expansion_factors)
        s.set_initial_distribution(b.x0, b.p0)
        out[pkg] = s.solve(t_final, fsp_tol)
    ref, port = out["ref"], out["port"]
    assert set(_by_state(ref.states, ref.p)) == \
        set(_by_state(port.states, port.p))
    for want, got in [(ref.p, port.p)] + list(zip(ref.dp, port.dp)):
        w, g = _by_state(ref.states, want), _by_state(port.states, got)
        assert max(abs(w[k] - g[k]) for k in w) <= 1e-12
    np.testing.assert_allclose(port.sinks, np.asarray(ref.sinks), rtol=0,
                               atol=1e-14)


def _sens(pkg_solver, mod, name, **kw):
    b = getattr(mod.models, name)()
    s = pkg_solver(odes_type="krylov", **kw)
    s.set_model(b.model)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors(b.expansion_factors)
    s.set_initial_distribution(b.x0, b.p0)
    return s


def _assert_same_solution(want, got, tol):
    assert set(_by_state(want.states, want.p)) == \
        set(_by_state(got.states, got.p))
    for a, b in [(want.p, got.p)] + list(zip(want.dp, got.dp)):
        w, g = _by_state(want.states, a), _by_state(got.states, b)
        assert max(abs(w[k] - g[k]) for k in w) <= tol


def test_ell_sens_solve_matches_the_reference_package_and_the_box(
        monkeypatch):
    """poisson_sens to t = 1 on the compressed backend: the reference
    package's compressed solve (its plain gather) and the port's box
    solve, p and dp by state within 1e-12."""
    monkeypatch.setenv("PACMENSL_ELL_GATHER", "plain")
    ref = _sens(JSensSolver, pm, "poisson_sens", backend="ell").solve(
        1.0, 1e-7)
    s = _sens(pt.SensFspSolverMultiSinks, pt, "poisson_sens",
              backend="ell", device="cpu")
    port = s.solve(1.0, 1e-7)
    assert s._backend_used == "ell"
    assert isinstance(s._operator.base, pt.EllOperator)
    np.testing.assert_array_equal(port.states, ref.states)
    _assert_same_solution(ref, port, 1e-12)
    box = _sens(pt.SensFspSolverMultiSinks, pt, "poisson_sens",
                backend="box", device="cpu").solve(1.0, 1e-7)
    _assert_same_solution(box, port, 1e-12)


def test_sens_solve_migrates_with_every_sensitivity(monkeypatch):
    """A box sensitivity solve over its memory budget migrates to the
    compressed backend, p and every sensitivity carried over together:
    the telegraph model to t = 1 against the box-only solve."""
    box = _sens(pt.SensFspSolverMultiSinks, pt, "telegraph",
                backend="box", device="cpu").solve(1.0, 1e-6)
    monkeypatch.setenv("PACMENSL_BOX_MEM_BUDGET", "1e4")
    s = _sens(pt.SensFspSolverMultiSinks, pt, "telegraph", backend="box",
              device="cpu")
    mig = s.solve(1.0, 1e-6)
    assert s._backend_used == "ell"
    _assert_same_solution(box, mig, 1e-10)
    assert mig.compute_fim().shape == (4, 4)


def test_fim_marginal_and_checkpoints_both_ways(tmp_path):
    d = _poisson("cvode")
    fim = d.compute_fim()
    assert fim.shape == (1, 1)
    # Poisson FIM w.r.t. lambda at time t: t^2 / (lambda t) for one draw
    assert fim[0, 0] == pytest.approx(1.0 / 2.0, rel=1e-2)
    sm = d.sens_marginal(0, 0)
    assert sm.sum() == pytest.approx(d.dp[0].sum())
    assert d.sens_weighted_average(0, lambda x: x[:, 0]) == pytest.approx(
        float(d.states[:, 0] @ d.dp[0]))
    # the reference package's answers on the same distribution
    ref = JSensDist(**interop.sens_distribution_to_reference(d))
    np.testing.assert_array_equal(ref.compute_fim(), fim)
    np.testing.assert_array_equal(ref.sens_marginal(0, 0), sm)
    # port -> file -> reference, and reference -> file -> port
    d.save(str(tmp_path / "port.npz"))
    r = JSensDist.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(r.dp, d.dp)
    np.testing.assert_array_equal(r.p, d.p)
    ref.save(str(tmp_path / "ref.npz"))
    for back in (pt.SensDiscreteDistribution.load(str(tmp_path / "ref.npz")),
                 interop.sens_distribution_from_reference(
                     str(tmp_path / "ref.npz")),
                 interop.sens_distribution_from_reference(ref)):
        np.testing.assert_array_equal(back.dp, d.dp)
        np.testing.assert_array_equal(back.states, d.states)
        np.testing.assert_array_equal(back.sinks, d.sinks)


def test_restart_from_a_sens_distribution():
    """A solve to t = 1 resumed from its own distribution to t = 2 (as
    the reference package takes one) ends where one solve to t = 2 does,
    within the truncation tolerance."""
    b = pt.models.poisson_sens(2.0)
    half = _poisson("cvode")
    s = _solver(b, "cvode", [5], [0.5])
    s.set_ode_tolerances(1e-8, 1e-14)
    s.set_initial_distribution(half)
    d = s.solve(2.0, 1e-7, t_init=1.0)
    full = _poisson("cvode", t_final=2.0)
    w, g = _by_state(full.states, full.dp[0]), _by_state(d.states, d.dp[0])
    assert sum(abs(w.get(k, 0.0) - g.get(k, 0.0))
               for k in set(w) | set(g)) <= 1e-5


def test_unported_paths_raise():
    """A mesh is taken (it raised before the sensitivity solve over ranks
    was ported); a model without sensitivities and a dp0 of the wrong
    shape raise."""
    from pacmensl_tpu_torch.parallel.mesh import StateMesh
    mesh = StateMesh(None, 0, 1, "cpu")
    assert pt.SensFspSolverMultiSinks(mesh=mesh).mesh is mesh
    s = pt.SensFspSolverMultiSinks(device="cpu")
    with pytest.raises(pt.SetupError, match="SensModel"):
        s.set_model(pt.models.poisson().model)
    b = pt.models.telegraph()
    s.set_model(b.model)
    with pytest.raises(pt.SetupError, match="dp0"):
        s.set_initial_distribution(b.x0, b.p0, dp0=np.zeros((3, 1)))


@pytest.mark.parametrize("cls", ["FspSolverMultiSinks",
                                 "SensFspSolverMultiSinks"])
def test_a_dropped_solver_is_freed_at_once(cls):
    """No reference cycle between the driver and its integrator: a
    dropped solver frees its box-sized vectors without waiting for the
    cycle collector."""
    import gc
    import weakref
    b = pt.models.poisson_sens(2.0)
    s = getattr(pt, cls)(odes_type="cvode", device="cpu")
    s.set_model(b.model)
    s.set_initial_bounds([5])
    s.set_expansion_factors([0.5])
    s.set_initial_distribution(b.x0, b.p0)
    s.solve(0.5, 1e-6)
    refs = [weakref.ref(s), weakref.ref(s._ode_solver),
            weakref.ref(s._operator)]
    gc.disable()
    try:
        del s
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
