"""The port's matrix-free GMRES against the reference package's
(``pacmensl_tpu.ops.gmres.gmres``) on a fixed toggle operator: the BDF
corrector matrix ``I - c A`` of the box operator, a right-hand side made
with numpy from a seed.  Both run in float64 with the same restarts; the
solutions agree to 1e-12 with the same matvec count and convergence flag
(the Arnoldi sums are taken in another order, so the last bits differ).
The capturable map BDF hands GMRES gives the callable's bits, and the
zero guess (``x0=None``) an explicit zero vector's with one matvec and
one residual read fewer."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.ops import vecops as jvo  # noqa: E402
from pacmensl_tpu.ops.box_operator import BoxOperator as JOp  # noqa: E402
from pacmensl_tpu.ops.gmres import gmres as jgmres  # noqa: E402
from pacmensl_tpu.statespace.box_space import BoxStateSpace as JBox  # noqa: E402
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.ops import vecops as tvo  # noqa: E402
from pacmensl_tpu_torch.ops.box_operator import ShiftedAction  # noqa: E402
from pacmensl_tpu_torch.ops.gmres import ArnoldiGraphs  # noqa: E402
from pacmensl_tpu_torch.ops.gmres import gmres as tgmres  # noqa: E402
from pacmensl_tpu_torch.sys import events  # noqa: E402

BOUNDS = np.array([12, 9, 40])
C = 0.75


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
    assert tuple(js.shape) == tuple(ts.shape)
    return JOp(jb.model, js, dtype=jnp.float64), pt.BoxOperator(tb.model, ts)


def _rhs(js_mask, n_c, seed):
    rng = np.random.default_rng(seed)
    p = np.where(js_mask, rng.standard_normal(js_mask.shape), 0.0)
    return p, rng.standard_normal(n_c)


@pytest.mark.parametrize("restart,tol,max_restarts,seed", [
    (16, 1e-10, 40, 0),        # the BDF defaults
    (4, 1e-12, 40, 1),         # several restart cycles
    (2, 1e-14, 1, 2),          # stops unconverged
])
def test_gmres_matches_reference(toggle_ops, restart, tol, max_restarts,
                                 seed):
    jop, top = toggle_ops
    mask = np.asarray(jop.space.mask_host)
    n_c = jop.num_constraints
    p, sk = _rhs(mask, n_c, seed)

    def j_apply(v):
        return jvo.axpy(-C, jop.action(0.0, v), v)

    def t_apply(v):
        return tvo.axpy(-C, top.action(0.0, v), v)

    jb = jvo.FspVector(p=jnp.asarray(p), sinks=jnp.asarray(sk))
    tb = tvo.FspVector(p=torch.as_tensor(p.reshape(-1)),
                       sinks=torch.as_tensor(sk))
    want = jgmres(j_apply, jb, jvo.zeros_like(jb), restart=restart, tol=tol,
                  max_restarts=max_restarts)
    got = tgmres(t_apply, tb, tvo.zeros_like(tb), restart=restart, tol=tol,
                 max_restarts=max_restarts)
    assert got.n_matvecs == int(want.n_matvecs)
    assert got.converged == bool(want.converged)
    assert got.converged == (max_restarts > 1)
    np.testing.assert_allclose(got.x.p.numpy(),
                               np.asarray(want.x.p).reshape(-1),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.x.sinks.numpy(), np.asarray(want.x.sinks),
                               rtol=0, atol=1e-12)
    assert got.res_norm == pytest.approx(float(want.res_norm), rel=1e-6,
                                         abs=1e-15)


def test_gmres_nan_rhs_stops_unconverged(toggle_ops):
    """A non-finite right-hand side ends the solve at once, unconverged,
    with x0 returned (the reference's NaN target)."""
    _, top = toggle_ops
    b = top.zero_vector()
    b.p[0] = float("nan")
    res = tgmres(lambda v: v, b, tvo.zeros_like(b))
    assert not res.converged and res.n_matvecs == 0
    assert torch.equal(res.x.p, torch.zeros_like(b.p))


@pytest.mark.parametrize("restart,tol,max_restarts,seed", [
    (16, 1e-10, 40, 0),
    (4, 1e-12, 40, 1),
    (2, 1e-14, 1, 2),
])
def test_gmres_capturable_map_is_bitwise_the_callable(
        toggle_ops, restart, tol, max_restarts, seed):
    """GMRES given the capturable map ``v + s A v`` (BDF's
    ``ShiftedAction``) runs each Arnoldi iteration's device work as one
    function with the normalisation by a device scalar; on the host it
    runs eagerly and gives the callable's solution bitwise, with the same
    matvecs and residual."""
    _, top = toggle_ops
    p, sk = _rhs(top.space.mask.numpy(), top.num_constraints, seed)
    b = tvo.FspVector(p=torch.as_tensor(p.reshape(-1)),
                      sinks=torch.as_tensor(sk))
    kw = dict(restart=restart, tol=tol, max_restarts=max_restarts)
    want = tgmres(lambda v: tvo.axpy(-C, top.action(0.0, v), v), b,
                  tvo.zeros_like(b), **kw)
    shifted = ShiftedAction(top)
    shifted.set(0.0, -C)
    for graphs in (None, ArnoldiGraphs()):
        got = tgmres(shifted, b, tvo.zeros_like(b), graphs=graphs, **kw)
        assert torch.equal(got.x.p, want.x.p)
        assert torch.equal(got.x.sinks, want.x.sinks)
        assert (got.n_matvecs, got.converged, got.res_norm) == (
            want.n_matvecs, want.converged, want.res_norm)


def _counting(top):
    """The corrector map as a callable, and its list of calls."""
    calls = []

    def apply(v):
        calls.append(1)
        return tvo.axpy(-C, top.action(0.0, v), v)
    return apply, calls


def _run(apply, b, x0, **kw):
    log = events.EventLog()
    with events.active(log):
        res = tgmres(apply, b, x0, **kw)
    return res, {k: v.count for k, v in log.events.items()}


@pytest.mark.parametrize("restart,tol,max_restarts,seed", [
    (16, 1e-10, 40, 0),
    (4, 1e-12, 40, 1),         # several restart cycles
    (2, 1e-14, 1, 2),
])
def test_gmres_zero_guess_is_bitwise_the_zero_vector(
        toggle_ops, restart, tol, max_restarts, seed):
    """``x0=None`` (SPGMR's zero guess) gives the solution of an explicit
    zero ``x0`` bit for bit, with the same matvecs, residual and
    convergence, on the callable and on the capturable map; its first
    cycle applies no map and reads no residual norm."""
    _, top = toggle_ops
    p, sk = _rhs(top.space.mask.numpy(), top.num_constraints, seed)
    b = tvo.FspVector(p=torch.as_tensor(p.reshape(-1)),
                      sinks=torch.as_tensor(sk))
    kw = dict(restart=restart, tol=tol, max_restarts=max_restarts)
    apply, calls = _counting(top)
    want, nw = _run(apply, b, tvo.zeros_like(b), **kw)
    n_want = len(calls)
    del calls[:]
    got, ng = _run(apply, b, None, **kw)
    assert torch.equal(got.x.p, want.x.p)
    assert torch.equal(got.x.sinks, want.x.sinks)
    assert torch.equal(torch.signbit(got.x.p), torch.signbit(want.x.p))
    assert (got.n_matvecs, got.converged, got.res_norm) == (
        want.n_matvecs, want.converged, want.res_norm)
    assert len(calls) == n_want - 1
    assert ng.get("HostSync.GMRESResidual", 0) == (
        nw["HostSync.GMRESResidual"] - 1)
    assert ng["GMRESZeroGuess"] == 1 and "GMRESZeroGuess" not in nw
    shifted = ShiftedAction(top)
    shifted.set(0.0, -C)
    for graphs in (None, ArnoldiGraphs()):
        m = tgmres(shifted, b, None, graphs=graphs, **kw)
        assert torch.equal(m.x.p, want.x.p)
        assert torch.equal(m.x.sinks, want.x.sinks)
        assert (m.n_matvecs, m.converged, m.res_norm) == (
            want.n_matvecs, want.converged, want.res_norm)


def test_gmres_nonzero_guess_applies_the_map_each_cycle(toggle_ops):
    """With a guess other than None every cycle opens with the residual
    matvec and its norm: one call of the map beyond the Arnoldi
    iterations and one ``HostSync.GMRESResidual`` a cycle, no
    ``GMRESZeroGuess``; the solution is the same to rounding."""
    _, top = toggle_ops
    p, sk = _rhs(top.space.mask.numpy(), top.num_constraints, 3)
    b = tvo.FspVector(p=torch.as_tensor(p.reshape(-1)),
                      sinks=torch.as_tensor(sk))
    rng = np.random.default_rng(4)
    x0 = tvo.FspVector(
        p=torch.as_tensor(rng.standard_normal(b.p.shape)) * 1e-3
        * top.space.mask.reshape(-1),
        sinks=torch.as_tensor(rng.standard_normal(b.sinks.shape)) * 1e-3)
    apply, calls = _counting(top)
    got, n = _run(apply, b, x0, restart=4, tol=1e-12)
    cycles = n["HostSync.GMRESResidual"]
    assert cycles > 1 and "GMRESZeroGuess" not in n
    assert len(calls) == got.n_matvecs + cycles
    ref, _ = _run(apply, b, None, restart=4, tol=1e-12)
    assert got.converged and ref.converged
    np.testing.assert_allclose(got.x.p.numpy(), ref.x.p.numpy(), rtol=0,
                               atol=1e-10)


def test_gmres_zero_guess_nan_rhs_returns_zeros(toggle_ops):
    """A non-finite right-hand side from the zero guess ends the solve at
    once, unconverged, with the zero vector returned and no map applied."""
    _, top = toggle_ops
    b = top.zero_vector()
    b.p[0] = float("nan")
    calls = []
    res = tgmres(lambda v: calls.append(1) or v, b, None)
    assert not res.converged and res.n_matvecs == 0 and not calls
    assert torch.equal(res.x.p, torch.zeros_like(b.p))
    assert torch.equal(res.x.sinks, torch.zeros_like(b.sinks))
