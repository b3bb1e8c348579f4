"""The port's BDF integrator against the reference package's
(``pacmensl_tpu.solvers.bdf.BdfSolver``) on fixed box operators (toggle,
and the time-varying hog1p_3d), with the same float64 defaults: the same
status, accepted steps, rejections, matvecs and orders, the end time to
1e-8 relative, and ``y`` to 1e-10.  Then
the FSP stop-check's revert, the failure of a matvec that turns NaN
(``tests/test_ode.py:66-112``); the capturable map of a box operator,
and of a box sensitivity operator, against the callable path, the
stacked action's counters the same on both, the map built only over box
operators without a mesh, and c(t) once per step."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.ops.box_operator import BoxOperator as JOp  # noqa: E402
from pacmensl_tpu.ops.vecops import FspVector as JVec  # noqa: E402
from pacmensl_tpu.solvers.bdf import BdfSolver as JBdf  # noqa: E402
from pacmensl_tpu.statespace.box_space import BoxStateSpace as JBox  # noqa: E402
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.ops import box_kernel as bk  # noqa: E402
from pacmensl_tpu_torch.ops import gmres as gm  # noqa: E402
from pacmensl_tpu_torch.ops import vecops as vo  # noqa: E402
from pacmensl_tpu_torch.ops.box_operator import ShiftedAction  # noqa: E402
from pacmensl_tpu_torch.ops.sens_operator import SensOperator  # noqa: E402
from pacmensl_tpu_torch.parallel.mesh import StateMesh  # noqa: E402
from pacmensl_tpu_torch.solvers.base import (  # noqa: E402
    STATUS_OK, STATUS_FSP_STOP, STATUS_FAILURE)
from pacmensl_tpu_torch.sys import events  # noqa: E402

Y_TOL = 1e-10


def _ops(name, bounds):
    jb, tb = pm.models.ALL_MODELS[name](), pt.models.ALL_MODELS[name]()
    js = JBox(jb.model.stoichiometry,
              pm.ConstraintSet(jb.constraint, bounds, jb.expansion_factors),
              jb.x0)
    ts = pt.BoxStateSpace(
        tb.model.stoichiometry,
        pt.ConstraintSet(tb.constraint, bounds, tb.expansion_factors),
        tb.x0, device="cpu")
    assert tuple(js.shape) == tuple(ts.shape)
    jop = JOp(jb.model, js, dtype=jnp.float64)
    top = pt.BoxOperator(tb.model, ts)
    p0 = np.zeros(js.shape)
    p0[tuple(jb.x0[0])] = 1.0
    n_c = js.num_constraints
    jy = JVec(p=jnp.asarray(p0), sinks=jnp.zeros(n_c))
    ty = pt.FspVector(p=torch.as_tensor(p0.reshape(-1)),
                      sinks=torch.zeros(n_c, dtype=torch.float64))
    return jop, top, jy, ty


def _same(jr, tr, y_rtol=0.0):
    assert tr.status == int(jr.status)
    assert tr.stats.n_steps == int(jr.stats.n_steps)
    assert tr.stats.n_rejected == int(jr.stats.n_rejected)
    assert tr.stats.n_matvecs == int(jr.stats.n_matvecs)
    # adaptive step control carries rounding-level differences of the
    # error norms (sums in another order) into the step sizes: measured
    # 3.6e-9 relative on toggle to t = 100, with the same steps
    assert tr.t == pytest.approx(float(jr.t), rel=1e-8)
    np.testing.assert_allclose(tr.y.p.numpy(),
                               np.asarray(jr.y.p).reshape(-1),
                               rtol=y_rtol, atol=Y_TOL)
    np.testing.assert_allclose(tr.y.sinks.numpy(), np.asarray(jr.y.sinks),
                               rtol=y_rtol, atol=Y_TOL)


@pytest.mark.parametrize("name,bounds,t_final", [
    ("toggle", [12, 9, 40], 100.0),
    ("hog1p_3d", [3, 8, 8, 4, 12, 12, 12], 20.0),
])
def test_bdf_matches_reference(name, bounds, t_final):
    jop, top, jy, ty = _ops(name, np.asarray(bounds))
    jr = JBdf(jop.action).solve(jy, 0.0, t_final)
    tr = pt.BdfSolver(top.action).solve(ty, 0.0, t_final)
    assert tr.status == STATUS_OK and tr.t == t_final
    _same(jr, tr)
    # the order travels in the step trace
    orders = tr.trace.aux[:tr.stats.n_steps]
    assert orders.min() >= 1 and orders.max() <= 5
    np.testing.assert_array_equal(
        orders, np.asarray(jr.trace.aux)[:tr.stats.n_steps])


def test_bdf_stop_check_reverts():
    """A violated stop-check keeps the last accepted state and returns
    status 1, as CvodeFsp does; both packages stop at the same point."""
    jop, top, jy, ty = _ops("toggle", np.array([12, 9, 40]))
    tol, t_final = 1e-6, 100.0

    def jcheck(t, y):
        return y.sinks * 3 - tol * (t / t_final)

    def tcheck(t, y):
        return y.sinks.numpy() * 3 - tol * (t / t_final)

    jr = JBdf(jop.action, stop_check=jcheck).solve(jy, 0.0, t_final)
    tr = pt.BdfSolver(top.action, stop_check=tcheck).solve(ty, 0.0, t_final)
    assert tr.status == STATUS_FSP_STOP and tr.t < t_final
    assert (tcheck(tr.t, tr.y) <= 1e-14).all()     # the reverted state
    assert tr.viol_excess.max() > 0                 # what stopped it
    # the stop lands after 145 steps, 6.5e-8 apart in t (9.5e-10
    # relative, see _same); y there moves by as much relative
    _same(jr, tr, y_rtol=1e-8)


def test_bdf_bad_matvec_fails():
    """A matvec that turns NaN after t > 1 ends the solve with status -1
    (reference test_ode.cpp:188,261)."""
    jop, top, jy, ty = _ops("toggle", np.array([12, 9, 40]))

    def jbad(t, y):
        d = jop.action(t, y)
        return JVec(p=d.p * jnp.where(t > 1.0, jnp.nan, 1.0), sinks=d.sinks)

    def tbad(t, y):
        d = top.action(t, y)
        return pt.FspVector(p=d.p * (float("nan") if t > 1.0 else 1.0),
                            sinks=d.sinks)

    jr = JBdf(jbad).solve(jy, 0.0, 100.0)
    tr = pt.BdfSolver(tbad).solve(ty, 0.0, 100.0)
    assert int(jr.status) == STATUS_FAILURE == tr.status
    assert tr.t <= 1.0 + 1e-12
    assert np.isfinite(tr.y.p.numpy()).all()


def _box(name, bounds, mesh=None):
    """A box operator of ``name`` at ``bounds`` on the host (for a
    sensitivity model its :class:`SensOperator`), and the point mass at
    its initial state (the stacked vector, sensitivities 0)."""
    b = getattr(pt.models, name)()
    space = pt.BoxStateSpace(
        b.model.stoichiometry,
        pt.ConstraintSet(b.constraint, np.asarray(bounds),
                         b.expansion_factors, b.model.num_species),
        b.x0, device="cpu")
    if isinstance(b.model, pt.SensModel):
        op = SensOperator(b.model, space, mesh=mesh)
        m = 1 + op.n_par
    else:
        op, m = pt.BoxOperator(b.model, space, mesh=mesh), 1
    p0 = np.zeros((m,) + tuple(space.shape))
    p0[(0,) + tuple(np.asarray(b.x0)[0])] = 1.0
    return op, pt.FspVector(
        p=torch.as_tensor(p0.reshape(-1)),
        sinks=torch.zeros(m * space.num_constraints, dtype=torch.float64))


#: (bundle, bounds, t_final): box operators, and box sensitivity operators
#: (derivative propensities; a derivative time coefficient)
MAP_CASES = [
    ("hog1p_5d", [3, 6, 6, 6, 6, 8, 8], 0.25),
    ("repressilator", [25, 15, 15, 60, 30, 60], 0.1),
    ("hog1p_3d_sens", [3, 5, 5, 3, 8, 8, 8], 2.0),
    ("poisson_sens", [12], 1.0),
]


@pytest.mark.parametrize("name,bounds,t_final", MAP_CASES)
def test_bdf_capturable_map_is_bitwise_the_callable(name, bounds, t_final):
    """BDF on a box operator, or on a box sensitivity operator's stacked
    action, hands GMRES the capturable map (``ShiftedAction``; on a card
    its Arnoldi iterations replay from CUDA graphs).  Run eagerly on the
    host it gives the callable path's ``p``, sinks, steps and matvecs
    bitwise."""
    op, y = _box(name, bounds)
    callable_ = pt.BdfSolver(lambda t, v: op.action(t, v))
    assert callable_._shifted is None
    want = callable_.solve(y, 0.0, t_final)
    solver = pt.BdfSolver(op.action)
    assert isinstance(solver._shifted, ShiftedAction)
    got = solver.solve(y, 0.0, t_final)
    assert got.status == want.status == STATUS_OK
    assert got.t == want.t and got.stats == want.stats
    assert torch.equal(got.y.p, want.y.p)
    assert torch.equal(got.y.sinks, want.y.sinks)


@pytest.mark.parametrize("name,bounds,t_final", MAP_CASES[2:])
def test_sens_counters_are_the_callable_ones_on_the_map(name, bounds,
                                                         t_final):
    """The stacked action's counters ``SensActionStates`` and
    ``SensActionSinks`` total the same on the capturable map as on the
    callable path: (1 + Np) x the states and x the constraints an
    action, one action a matvec and one the residual of each GMRES cycle
    that applied the map to its start (none opens a solve: BDF hands GMRES
    the zero vector)."""
    op, y = _box(name, bounds)
    counts = []
    for matvec in (lambda t, v: op.action(t, v), op.action):
        log = events.EventLog()
        with events.active(log):
            res = pt.BdfSolver(matvec).solve(y, 0.0, t_final)
        counts.append({k: v.count for k, v in log.events.items()})
    want, got = counts
    m, n = 1 + op.n_par, want["SensAction"]
    assert want["GMRESZeroGuess"] == want["GMRES"]
    assert n == (res.stats.n_matvecs
                 + want.get("HostSync.GMRESResidual", 0))
    assert want["SensActionStates"] == n * m * op.space.num_states
    assert want["SensActionSinks"] == n * m * op.num_constraints
    for k in ("SensAction", "SensActionStates", "SensActionSinks"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("name,bounds,t_final", MAP_CASES[2:])
def test_sens_counts_of_a_capture_wait_for_its_replays(name, bounds,
                                                       t_final):
    """An Arnoldi iteration of the sensitivity map run inside
    ``events.deferred`` (as a CUDA graph capture runs it) counts nothing
    of ``SensActionStates``/``SensActionSinks`` until the kept tallies
    run, and each run of them adds what one eager iteration adds."""
    op, y = _box(name, bounds)
    shifted = ShiftedAction(op)
    shifted.set(0.5, -0.01)
    V = vo.basis_empty(y, 3)
    vo.basis_set(V, 0, y)
    work = gm._work(V)
    names = ("SensActionStates", "SensActionSinks")

    def counted(log):
        return [log.events[k].count if k in log.events else 0
                for k in names]
    eager, held = events.EventLog(), events.EventLog()
    with events.active(eager):
        gm._arnoldi_step(shifted, V, 0, work)
    with events.active(held):
        with events.deferred() as tallies:
            gm._arnoldi_step(shifted, V, 0, work)
        assert counted(held) == [0, 0] and len(tallies) == 1
        assert held.events["SensAction"].count == 1
        for k in (1, 2):
            for fn in tallies:
                fn()
            assert counted(held) == [k * v for v in counted(eager)]
    assert counted(eager)[0] == (1 + op.n_par) * op.space.num_states


def test_bdf_hands_the_map_only_to_unsharded_box_operators():
    """The capturable map is built over a box operator or a sensitivity
    operator over box operators, without a mesh; the same operators with
    a mesh (one rank here), a compressed sensitivity operator and a
    wrapper get the callable path."""
    mesh = StateMesh(None, 0, 1, "cpu")
    for name, bounds in (("hog1p_3d", [3, 5, 5, 3, 8, 8, 8]),
                         ("hog1p_3d_sens", [3, 5, 5, 3, 8, 8, 8]),
                         ("poisson_sens", [12])):
        op = _box(name, bounds)[0]
        assert isinstance(pt.BdfSolver(op.action)._shifted, ShiftedAction)
        assert pt.BdfSolver(lambda t, v: op.action(t, v))._shifted is None
        sharded = _box(name, bounds, mesh=mesh)[0]
        assert pt.BdfSolver(sharded.action)._shifted is None
    b = pt.models.hog1p_3d_sens()
    s = pt.SensFspSolverMultiSinks(backend="ell", device="cpu")
    s.set_model(b.model)
    s.set_constraint_functions(b.constraint)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors(b.expansion_factors)
    s.set_initial_distribution(b.x0, b.p0)
    s.set_up()
    assert s._backend_used == "ell"
    assert pt.BdfSolver(s._operator.action)._shifted is None


@pytest.mark.parametrize("capturable", [False, True])
def test_bdf_coefficients_once_per_step(capturable):
    """The box operator computes c(t) once for each t it is applied at:
    the first step's slope, then one per step attempt, whose right-hand
    side and GMRES matvecs share its t.  The capturable map (BDF given
    the operator's own ``action``) writes the kernel's coefficient buffer
    once per attempt at most: only where c(t) changed; the callable
    (a wrapper of it) launches no kernel on the host."""
    op, y = _ops("hog1p_3d", np.array([3, 8, 8, 4, 12, 12, 12]))[1::2]
    inputs = op.geom.inputs(op.device)
    matvec = op.action if capturable else (lambda t, v: op.action(t, v))
    log = events.EventLog()
    with events.active(log):
        res = pt.BdfSolver(matvec).solve(y, 0.0, 20.0)
    attempts = res.stats.n_steps + res.stats.n_rejected
    n = {k: v.count for k, v in log.events.items()}
    assert n["ModelCoefficients"] == 1 + attempts
    # every GMRES solve opens from the zero vector without a matvec; a
    # restart's residual is one
    assert n["GMRESZeroGuess"] == n["GMRES"] == attempts
    assert n["OperatorAction"] == (res.stats.n_matvecs
                                   + n.get("HostSync.GMRESResidual", 0))
    if capturable:
        assert 0 < inputs.writes <= attempts
        # c(t) of hog1p_3d's signal stays the same over some steps
        assert inputs.writes < attempts
    else:
        assert inputs.writes == 0


def test_kernel_inputs_write_only_changes():
    """The kernel's per-call inputs are copied to the device only where a
    value differs from the last written."""
    inp = bk.KernelInputs(3, 2, "cpu")
    inp.write([1.0, 2.0, 3.0], np.array([4, 5]))
    inp.write([1.0, 2.0, 3.0], np.array([4, 5]))
    inp.write([1.0, 2.0, 3.0])
    assert inp.writes == 1
    inp.write([1.0, 2.5, 3.0])
    inp.write([1.0, 2.5, 3.0], np.array([4, 6]))
    assert inp.writes == 3
    assert inp.buf[:3].view(torch.float64).tolist() == [1.0, 2.5, 3.0]
    assert inp.buf[3:].tolist() == [4, 6]
