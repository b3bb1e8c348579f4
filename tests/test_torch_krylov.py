"""The port's Krylov integrator against the reference package's
``KrylovSolver`` on a fixed toggle operator: the solution, the end time,
the status and the step and matvec counts agree (1e-10), with and without
an FSP stop-check that fires."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.ops.box_operator import BoxOperator as JOp  # noqa: E402
from pacmensl_tpu.ops.vecops import FspVector as JVec  # noqa: E402
from pacmensl_tpu.solvers.krylov import KrylovSolver as JKrylov  # noqa: E402
from pacmensl_tpu.statespace.box_space import BoxStateSpace as JBox  # noqa: E402
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.ops.expm import expm  # noqa: E402

BOUNDS = np.array([12, 9, 40])


@pytest.fixture(scope="module")
def toggle_ops():
    jb, tb = pm.models.toggle(), pt.models.toggle()
    js = JBox(jb.model.stoichiometry,
              pm.ConstraintSet(jb.constraint, BOUNDS, jb.expansion_factors),
              jb.x0)
    ts = pt.BoxStateSpace(
        tb.model.stoichiometry,
        pt.ConstraintSet(tb.constraint, BOUNDS, tb.expansion_factors),
        tb.x0, device="cpu")
    jop = JOp(jb.model, js, dtype=jnp.float64, use_pallas=False)
    top = pt.BoxOperator(tb.model, ts)
    p0 = np.zeros(js.shape)
    p0[0, 0] = 0.6
    p0[1, 0] = 0.4
    n_c = js.num_constraints
    jy = JVec(p=jnp.asarray(p0), sinks=jnp.zeros(n_c))
    ty = pt.FspVector(p=torch.as_tensor(p0.reshape(-1)),
                      sinks=torch.zeros(n_c, dtype=torch.float64))
    return jop, top, jy, ty


def _check(jr, tr):
    assert int(tr.status) == int(jr.status)
    assert tr.t == pytest.approx(float(jr.t), rel=1e-10, abs=0)
    assert tr.stats.n_steps == int(jr.stats.n_steps)
    assert tr.stats.n_matvecs == int(jr.stats.n_matvecs)
    assert tr.stats.n_rejected == int(jr.stats.n_rejected)
    np.testing.assert_allclose(tr.y.p.numpy(),
                               np.asarray(jr.y.p).reshape(-1),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tr.y.sinks.numpy(), np.asarray(jr.y.sinks),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("t_final", [50.0, 400.0])
def test_krylov_matches_reference(toggle_ops, t_final):
    jop, top, jy, ty = toggle_ops
    jr = JKrylov(jop.action, rhs_cost=jop.local_mv_flops()).solve(
        jy, 0.0, t_final)
    tr = pt.KrylovSolver(top.action, rhs_cost=top.local_mv_flops()).solve(
        ty, 0.0, t_final)
    assert int(jr.status) == 0
    _check(jr, tr)
    # the step trace records the same steps
    k = tr.stats.n_steps
    np.testing.assert_allclose(tr.trace.t[:k], np.asarray(jr.trace.t)[:k],
                               rtol=1e-10)
    np.testing.assert_array_equal(tr.trace.aux[:k],
                                  np.asarray(jr.trace.aux)[:k])


def test_krylov_stop_check_matches_reference(toggle_ops):
    """A stop-check that trips: status 1, the halved end time and the
    running max of the excesses agree."""
    jop, top, jy, ty = toggle_ops
    tol, t_final = 1e-6, 400.0

    def j_stop(t, y):
        return y.sinks * 3 - tol * (t / t_final)

    def t_stop(t, y):
        return y.sinks.numpy() * 3 - tol * (t / t_final)

    jr = JKrylov(jop.action, rhs_cost=jop.local_mv_flops(),
                 stop_check=j_stop).solve(jy, 0.0, t_final)
    tr = pt.KrylovSolver(top.action, rhs_cost=top.local_mv_flops(),
                         stop_check=t_stop).solve(ty, 0.0, t_final)
    assert int(jr.status) == 1
    _check(jr, tr)
    np.testing.assert_allclose(tr.viol_excess, np.asarray(jr.viol_excess),
                               rtol=1e-10, atol=1e-16)


def test_expm_matches_reference():
    from pacmensl_tpu.ops.expm import expm as jexpm
    rng = np.random.default_rng(5)
    for scale in (0.1, 3.0, 80.0):
        A = rng.standard_normal((12, 12)) * scale
        np.testing.assert_allclose(expm(torch.as_tensor(A)).numpy(),
                                   np.asarray(jexpm(jnp.asarray(A))),
                                   rtol=1e-10, atol=1e-12)
