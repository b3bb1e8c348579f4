"""The port's Krylov integrator on spaces smaller than its least Krylov
dimension (a happy breakdown must be accepted), the one-device cases of
tests/test_krylov_breakdown.py on both packages: the driver's Poisson
configuration with Krylov dimensions (10, 20) on a 9-state space, a
birth-death generator of 2 to 24 states against expm, and expansion
epochs that grow through m_min."""
import math

import numpy as np
import pytest
from scipy.linalg import expm
from scipy.stats import poisson as poisson_law

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.ops.vecops import FspVector as JVec  # noqa: E402
from pacmensl_tpu.solvers.krylov import KrylovSolver as JKrylov  # noqa: E402
import pacmensl_tpu_torch as pt  # noqa: E402


def _poisson_solver(pkg, m_rng=(10, 20), bounds=(8,)):
    b = pkg.models.poisson(2.0)
    kw = {"dtype": jnp.float64} if pkg is pm else {"device": "cpu"}
    s = pkg.FspSolverMultiSinks(backend="ell", odes_type="krylov", **kw)
    s.set_model(b.model)
    s.set_krylov_dim_range(*m_rng)
    s.set_initial_bounds(list(bounds))
    s.set_expansion_factors([1.0])
    s.set_initial_distribution(b.x0, b.p0)
    return s


@pytest.mark.parametrize("t_final", [0.5, 2.0])
def test_dryrun_config_small_space_small_m(t_final):
    d = _poisson_solver(pt).solve(t_final, 1e-4)
    pdf = poisson_law.pmf(d.states[:, 0], 2.0 * t_final)
    assert np.abs(d.p - pdf).sum() <= 1e-3
    dj = _poisson_solver(pm).solve(t_final, 1e-4)
    assert np.array_equal(np.asarray(dj.states), d.states)
    np.testing.assert_allclose(d.p, np.asarray(dj.p), rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [2, 5, 24])
def test_space_smaller_than_m_min_sweep(n):
    """A closed birth-death generator of n < m_min = 25 states."""
    A = np.zeros((n, n))
    for i in range(n):
        if i + 1 < n:
            A[i + 1, i] += 1.3
            A[i, i] -= 1.3
        if i > 0:
            A[i - 1, i] += 0.7
            A[i, i] -= 0.7
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    p0 = np.zeros(n)
    p0[0] = 1.0
    res = pt.KrylovSolver(lambda t, y: pt.FspVector(
        p=At @ y.p, sinks=torch.zeros_like(y.sinks))).solve(
        pt.FspVector(p=torch.as_tensor(p0),
                     sinks=torch.zeros(1, dtype=torch.float64)), 0.0, 3.0)
    assert res.status == 0 and res.stats.n_steps >= 1
    assert np.abs(res.y.p.numpy() - expm(3.0 * A) @ p0).max() < 1e-10
    jr = JKrylov(lambda t, y: JVec(p=Aj @ y.p, sinks=jnp.zeros_like(
        y.sinks)), dtype=jnp.float64).solve(
        JVec(p=jnp.asarray(p0), sinks=jnp.zeros(1)), 0.0, 3.0)
    assert res.stats.n_steps == int(jr.stats.n_steps)
    np.testing.assert_allclose(res.y.p.numpy(), np.asarray(jr.y.p),
                               rtol=0, atol=1e-12)


def test_expansion_epochs_cross_breakdown_boundary():
    s = _poisson_solver(pt)
    d = s.solve(2.0, 1e-4)
    assert s.events.events["ODESolve"].count >= 2
    err = sum(abs(float(pi) - math.exp(-4.0) * 4.0 ** int(x[0])
                  / math.factorial(int(x[0])))
              for x, pi in zip(d.states, d.p))
    assert err <= 1e-3, err
