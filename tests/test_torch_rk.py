"""The port's RK (Dormand-Prince 5(4)) and CN integrators and the driver's
``odes_type="petsc"`` against the reference package's.

* On fixed box operators (toggle, Poisson) ``RKSolver`` and ``CNSolver``
  take the reference's steps exactly: the same status, accepted steps,
  rejections and matvecs, ``y`` within 1e-12, the end time within 1e-10
  and the step times within 1e-8 relative (the error norms are sums in
  another order).
* The FSP stop (halve and retry) and a matvec that turns NaN
  (``tests/test_ode.py:72-111``).
* ``set_ts_type`` runs ``rk``, ``cn`` and ``bdf`` under ``petsc`` on ELL
  and on the box against the Poisson oracle (``tests/test_ode.py:113-130``),
  and an unknown name raises ``SetupError`` (``:132-141``).
* The repressilator to t = 0.5 under ``petsc`` (set by options, as the
  example does) in both packages within 2 fsp_tol, and ``poisson_sens``
  under ``petsc`` in both packages.
"""
import numpy as np
import pytest
from scipy.stats import poisson as poisson_law

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.ops.box_operator import BoxOperator as JOp  # noqa: E402
from pacmensl_tpu.ops.ell_operator import EllOperator as JEll  # noqa: E402
from pacmensl_tpu.ops.vecops import FspVector as JVec  # noqa: E402
from pacmensl_tpu.solvers.cn import CNSolver as JCN  # noqa: E402
from pacmensl_tpu.solvers.rk import RKSolver as JRK  # noqa: E402
from pacmensl_tpu.statespace.box_space import BoxStateSpace as JBox  # noqa: E402
from pacmensl_tpu.statespace.state_set import StateSet as JSet  # noqa: E402
from pacmensl_tpu.sys.options import Options as JOptions  # noqa: E402
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.solvers.base import (  # noqa: E402
    STATUS_OK, STATUS_FSP_STOP, STATUS_FAILURE)

Y_TOL = 1e-12


def _ops(name, bounds):
    """The same box operator in both packages, and y0 at the bundle's
    initial state."""
    jb, tb = pm.models.ALL_MODELS[name](), pt.models.ALL_MODELS[name]()
    ns = tb.model.num_species
    js = JBox(jb.model.stoichiometry,
              pm.ConstraintSet(jb.constraint, bounds, jb.expansion_factors,
                               ns), jb.x0)
    ts = pt.BoxStateSpace(
        tb.model.stoichiometry,
        pt.ConstraintSet(tb.constraint, bounds, tb.expansion_factors, ns),
        tb.x0, device="cpu")
    assert tuple(js.shape) == tuple(ts.shape)
    p0 = np.zeros(js.shape)
    p0[tuple(jb.x0[0])] = 1.0
    n_c = js.num_constraints
    return (JOp(jb.model, js, dtype=jnp.float64), pt.BoxOperator(tb.model, ts),
            JVec(p=jnp.asarray(p0), sinks=jnp.zeros(n_c)),
            pt.FspVector(p=torch.as_tensor(p0.reshape(-1)),
                         sinks=torch.zeros(n_c, dtype=torch.float64)))


def _same(jr, tr):
    assert tr.status == int(jr.status)
    assert tr.stats.n_steps == int(jr.stats.n_steps)
    assert tr.stats.n_rejected == int(jr.stats.n_rejected)
    assert tr.stats.n_matvecs == int(jr.stats.n_matvecs)
    assert tr.t == pytest.approx(float(jr.t), rel=1e-10)
    np.testing.assert_allclose(tr.y.p.numpy(),
                               np.asarray(jr.y.p).reshape(-1), rtol=0.0,
                               atol=Y_TOL)
    np.testing.assert_allclose(tr.y.sinks.numpy(), np.asarray(jr.y.sinks),
                               rtol=0.0, atol=Y_TOL)


@pytest.mark.parametrize("method,name,bounds,t_final", [
    ("rk", "toggle", [12, 9, 40], 5.0),
    ("rk", "poisson", [30], 4.0),
    # CN's first-order error estimate against atol = 1e-14 takes
    # thousands of steps on these from a point mass (the reference's
    # too): short spans
    ("cn", "toggle", [12, 9, 40], 0.1),
    ("cn", "poisson", [30], 0.005),
])
def test_solver_matches_reference(method, name, bounds, t_final):
    jop, top, jy, ty = _ops(name, np.asarray(bounds))
    jcls, tcls = (JRK, pt.RKSolver) if method == "rk" else (JCN, pt.CNSolver)
    jr = jcls(jop.action).solve(jy, 0.0, t_final)
    tr = tcls(top.action).solve(ty, 0.0, t_final)
    assert tr.status == STATUS_OK and tr.t == t_final
    assert tr.stats.n_steps > 3
    _same(jr, tr)
    # the step trace: every accepted step's end time, in order; the step
    # sizes carry the norms' rounding (1.2e-10 relative measured on the
    # toggle), as BDF's do (tests/test_torch_bdf.py)
    times = tr.trace.t[:tr.stats.n_steps]
    assert (np.diff(times) > 0).all() and times[-1] == pytest.approx(t_final)
    np.testing.assert_allclose(times, np.asarray(jr.trace.t)[
        :tr.stats.n_steps], rtol=1e-8)


def _poisson_ell(pkg, set_cls, op_cls):
    b = pkg.models.poisson(2.0)
    cs = pkg.ConstraintSet(None, [5], [0.1], 1)
    kw = {} if pkg is pm else {"device": "cpu"}
    ss = set_cls(b.model.stoichiometry, cs, init_states=[[0]])
    ss.expand()
    op = op_cls(b.model, ss, **kw)
    y0 = np.zeros(op.n_pad)
    y0[ss.state2index([[0]])[0]] = 1.0
    return op, y0


def test_rk_fsp_stop_condition():
    """With a tight bound the sink check stops RK early with status 1 at a
    state that meets the check (RK halves and re-steps), where the
    reference stops (tests/test_ode.py:88-111)."""
    fsp_tol, t_final = 1e-6, 10.0
    jop, jy0 = _poisson_ell(pm, JSet, JEll)
    top, ty0 = _poisson_ell(pt, pt.StateSet, pt.EllOperator)
    jr = JRK(jop.action, stop_check=lambda t, y: jnp.max(y.sinks)
             - fsp_tol * (t / t_final)).solve(
        JVec(p=jnp.asarray(jy0), sinks=jnp.zeros(1)), 0.0, t_final)
    tr = pt.RKSolver(top.action, stop_check=lambda t, y: y.sinks.max()
                     - fsp_tol * (t / t_final)).solve(
        pt.FspVector(p=torch.as_tensor(ty0), sinks=torch.zeros(
            1, dtype=torch.float64)), 0.0, t_final)
    assert tr.status == STATUS_FSP_STOP == int(jr.status)
    assert tr.t < t_final
    assert float(tr.y.sinks.max()) <= fsp_tol * tr.t / t_final + 1e-14
    assert tr.viol_excess.max() > 0
    assert tr.stats.n_steps == int(jr.stats.n_steps)
    assert tr.stats.n_rejected == int(jr.stats.n_rejected)
    assert tr.t == pytest.approx(float(jr.t), rel=1e-10)


def test_bad_matvec_fails():
    """A matvec that turns NaN after t > 1 ends the RK solve with status
    -1 (tests/test_ode.py:72-85), at the last good state.  (CN, as the
    reference's, rejects such a step as a stalled linear solve and
    shrinks h; the reference tests RK only.)"""
    cls = pt.RKSolver
    _, top, _, ty = _ops("toggle", np.array([12, 9, 40]))

    def bad(t, y):
        d = top.action(t, y)
        return pt.FspVector(p=d.p * (float("nan") if t > 1.0 else 1.0),
                            sinks=d.sinks)

    tr = cls(bad).solve(ty, 0.0, 100.0)
    assert tr.status == STATUS_FAILURE
    assert tr.t <= 1.0 + 1e-12
    assert np.isfinite(tr.y.p.numpy()).all()


@pytest.mark.parametrize("backend", ["ell", "box"])
@pytest.mark.parametrize("ts_type", ["rk", "cn", "bdf"])
def test_ts_type_pluggable(ts_type, backend):
    """The petsc backend runs each TS method (tests/test_ode.py:113-130):
    the Poisson oracle at a loose tolerance.  CN runs at ODE tolerances
    (1e-5, 1e-10) and fsp_tol 5e-5 (the reference's test: (1e-6, 1e-12),
    1e-4): its first-order error estimate against atol 1e-12 takes 5,180
    steps on ELL and 9,110 on the box, and misses the oracle's 1e-4 (my
    CPU runs: 1.17e-4 and 1.59e-4)."""
    ode_tol, fsp_tol = (((1e-5, 1e-10), 5e-5) if ts_type == "cn"
                        else ((1e-6, 1e-12), 1e-4))
    b = pt.models.poisson(2.0)
    s = pt.FspSolverMultiSinks(backend=backend, odes_type="petsc",
                               device="cpu")
    s.set_ts_type(ts_type)
    s.set_model(b.model)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors([0.5])
    s.set_initial_distribution(b.x0, b.p0)
    s.set_ode_tolerances(*ode_tol)
    d = s.solve(4.0, fsp_tol)
    cls = {"rk": pt.RKSolver, "cn": pt.CNSolver, "bdf": pt.BdfSolver}
    assert type(s._ode_solver) is cls[ts_type]
    assert s._backend_used == backend
    pdf = poisson_law.pmf(d.states[:, 0], 2.0 * 4.0)
    assert np.abs(d.p - pdf).sum() <= 1e-4


def test_ts_type_unknown_rejected():
    """tests/test_ode.py:132-141."""
    s = pt.FspSolverMultiSinks(odes_type="petsc", device="cpu")
    s.SetTsType("weird")
    b = pt.models.poisson(2.0)
    s.set_model(b.model)
    s.set_initial_bounds(b.bounds)
    s.set_initial_distribution(b.x0, b.p0)
    with pytest.raises(pt.SetupError, match="weird"):
        s.solve(1.0, 1e-4)


def _by_state(d):
    return {tuple(x): float(p) for x, p in zip(d.states, d.p)}


def _l1(a, b):
    a, b = _by_state(a), _by_state(b)
    return sum(abs(a.get(k, 0.0) - b.get(k, 0.0)) for k in set(a) | set(b))


def _rep_petsc(pkg, opts, bounds=None):
    b = pkg.models.repressilator()
    kw = {} if pkg is pm else {"device": "cpu"}
    s = pkg.FspSolverMultiSinks(**kw)
    s.set_from_options(opts.from_argv(["-fsp_odes_type", "petsc"]))
    s.set_model(b.model)
    s.set_constraint_functions(b.constraint)
    s.set_initial_bounds(b.bounds if bounds is None else bounds)
    s.set_expansion_factors(b.expansion_factors)
    s.set_initial_distribution(b.x0, b.p0)
    return s


def test_repressilator_petsc_matches_reference():
    """The example's flags (``-fsp_odes_type petsc``) on both packages,
    each on its host default backend (ELL for custom constraints), to
    t = 0.5: the port from the bundle's bounds (22 epochs), then both from
    the bounds where it ended, one epoch each (the reference compiles its
    RK loop once per epoch: 64 s from the bundle's bounds to t = 0.1)."""
    tol, t_final = 1e-4, 0.5
    s = _rep_petsc(pt, pt.Options)
    d = s.solve(t_final, tol)
    assert type(s._ode_solver) is pt.RKSolver and s._backend_used == "ell"
    assert s.get_event_log().events["ODESolve"].count > 10
    assert d.p.sum() >= 1.0 - tol
    dj = _rep_petsc(pm, JOptions, d.bounds).solve(t_final, tol)
    dt = _rep_petsc(pt, pt.Options, d.bounds).solve(t_final, tol)
    assert _l1(dj, dt) <= 2 * tol
    assert _l1(d, dt) <= 2 * tol


def test_poisson_sens_petsc_matches_reference():
    """The sensitivity solve under petsc (RK over p and ds/dtheta) in both
    packages: p and dp agree within the integrators' tolerance."""
    out = []
    for pkg in (pm, pt):
        b = pkg.models.poisson_sens(2.0)
        kw = {} if pkg is pm else {"device": "cpu"}
        s = pkg.SensFspSolverMultiSinks(backend="ell", odes_type="petsc",
                                        **kw)
        s.set_model(b.model)
        s.set_initial_bounds([5])
        s.set_expansion_factors([0.5])
        s.set_initial_distribution(b.x0, b.p0)
        s.set_ode_tolerances(1e-8, 1e-14)
        out.append(s.solve(1.0, 1e-7))
    assert type(s._ode_solver) is pt.RKSolver
    j, t = out
    assert np.array_equal(np.asarray(j.states), t.states)
    np.testing.assert_allclose(t.p, np.asarray(j.p), rtol=0, atol=1e-9)
    np.testing.assert_allclose(t.dp, np.asarray(j.dp), rtol=0, atol=1e-9)
    # d/dlambda of Poisson(lambda t) at t = 1: (k / lambda - t) p_k
    k = t.states[:, 0]
    np.testing.assert_allclose(t.dp[0], (k / 2.0 - 1.0) * t.p, atol=1e-6)


def test_ts_steps_tool(capsys):
    """``tools/ts_steps.py`` reports one solve per end time."""
    from pacmensl_tpu_torch.tools import ts_steps
    ts_steps.main(["--ts", "rk", "--t", "0.05", "--backend", "ell",
                   "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and out[0].startswith("rk t=0.05 on ell (cpu): ")
    assert "steps" in out[0] and "RHS evaluations" in out[0]
