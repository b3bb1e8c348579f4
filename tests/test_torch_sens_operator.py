"""The port's sensitivity operator and the box operator's reaction subsets
and batched action, on the CPU.

* ``SensOperator.action`` and ``sens_action`` on the box against the
  reference package's ``SensOperator(..., BoxOperator)`` on the same
  seeded stacked vector, rtol 1e-12 / atol 1e-13 in float64 (sums of the
  same terms; the reference's XLA action adds them in another order).
* ``sens_action`` against a central difference of the port's own
  generator at perturbed parameters (the reference test_sensmat strategy),
  rtol 1e-6 / atol 1e-9: the difference quotient's truncation and
  rounding error at h = 1e-6.
* A reaction subset is the whole operator with the other reactions'
  coefficients set to 0, bitwise (adding an exact zero changes nothing).
* The batched plain versions are a loop of single plain calls, bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.ops.box_operator import BoxOperator as JOp  # noqa: E402
from pacmensl_tpu.ops.sens_operator import (  # noqa: E402
    SensOperator as JSensOp, SensFspVector as JSVec)
from pacmensl_tpu.ops.vecops import FspVector as JVec  # noqa: E402
from pacmensl_tpu.statespace.box_space import BoxStateSpace as JBox  # noqa
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.ops import box_kernel as bk  # noqa: E402
from pacmensl_tpu_torch.ops import box_operator as bo  # noqa: E402
from pacmensl_tpu_torch.ops.sens_operator import SensOperator  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-13)

CASES = [("telegraph", [1, 1, 6], 0.0),
         ("hog1p_3d_sens", [3, 5, 5, 3, 8, 8, 8], 30.0)]


def _space(bundle, bounds):
    cs = pt.ConstraintSet(bundle.constraint, np.asarray(bounds),
                          bundle.expansion_factors,
                          bundle.model.num_species)
    return pt.BoxStateSpace(bundle.model.stoichiometry, cs, bundle.x0,
                            device="cpu")


def _stacked(space, n_par, seed):
    """A seeded stacked vector: p and each s_j random on the valid
    states, the sinks random."""
    rng = np.random.default_rng(seed)
    mask = space.mask_host.reshape(-1)
    p = np.where(mask[None, :], rng.random((1 + n_par, mask.size)), 0.0)
    p[1:] -= 0.5 * mask[None, :]
    k = rng.random((1 + n_par, space.num_constraints))
    return p, k


@pytest.mark.parametrize("name,bounds,t", CASES)
def test_sens_operator_matches_the_reference_package(name, bounds, t):
    tb = pt.models.ALL_MODELS[name]()
    jb = pm.models.ALL_MODELS[name]()
    ts = _space(tb, bounds)
    js = JBox(jb.model.stoichiometry,
              pm.ConstraintSet(jb.constraint, np.asarray(bounds),
                               jb.expansion_factors), jb.x0)
    assert tuple(js.shape) == tuple(ts.shape)
    top = SensOperator(tb.model, ts)
    jop = JSensOp(jb.model, js, JOp, dtype=jnp.float64)
    m, nc = 1 + top.n_par, ts.num_constraints
    p, k = _stacked(ts, top.n_par, seed=3)
    shape = tuple(js.shape)
    want = jop.action(t, JSVec(
        p=jnp.asarray(p[0].reshape(shape)), sinks=jnp.asarray(k[0]),
        s=jnp.asarray(p[1:].reshape((m - 1,) + shape)),
        ssinks=jnp.asarray(k[1:])))
    got = top.action(t, pt.FspVector(p=torch.as_tensor(p.reshape(-1)),
                                     sinks=torch.as_tensor(k.reshape(-1))))
    np.testing.assert_allclose(
        got.p.numpy().reshape(m, -1)[0], np.asarray(want.p).reshape(-1),
        **TOL)
    np.testing.assert_allclose(
        got.p.numpy().reshape(m, -1)[1:],
        np.asarray(want.s).reshape(m - 1, -1), **TOL)
    np.testing.assert_allclose(got.sinks.numpy().reshape(m, nc)[0],
                               np.asarray(want.sinks), **TOL)
    np.testing.assert_allclose(got.sinks.numpy().reshape(m, nc)[1:],
                               np.asarray(want.ssinks), **TOL)
    v = pt.FspVector(p=torch.as_tensor(p[0]), sinks=torch.as_tensor(k[0]))
    jv = JVec(p=jnp.asarray(p[0].reshape(shape)), sinks=jnp.asarray(k[0]))
    for j in range(top.n_par):
        g, w = top.sens_action(j, t, v), jop.sens_action(j, t, jv)
        np.testing.assert_allclose(g.p.numpy(),
                                   np.asarray(w.p).reshape(-1), **TOL)
        np.testing.assert_allclose(g.sinks.numpy(), np.asarray(w.sinks),
                                   **TOL)


def test_sens_action_matches_finite_differences():
    theta = dict(k01=1.0e-2, k10=1.0e-1, kr=10.0, gamma=1.0)
    b = pt.models.telegraph(**theta)
    space = _space(b, [1, 1, 6])
    sop = SensOperator(b.model, space)
    rng = np.random.default_rng(0)
    mask = space.mask_host.reshape(-1)
    v = pt.FspVector(p=torch.as_tensor(np.where(mask, rng.random(mask.size),
                                                0.0)),
                     sinks=torch.zeros(3, dtype=torch.float64))
    h = 1e-6
    for j, name in enumerate(theta):
        dv = sop.sens_action(j, 0.0, v)
        tp = dict(theta, **{name: theta[name] + h})
        tm = dict(theta, **{name: theta[name] - h})
        ap = pt.BoxOperator(pt.models.telegraph(**tp).model,
                            space).action(0.0, v)
        am = pt.BoxOperator(pt.models.telegraph(**tm).model,
                            space).action(0.0, v)
        np.testing.assert_allclose(dv.p.numpy(),
                                   ((ap.p - am.p) / (2 * h)).numpy(),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(dv.sinks.numpy(),
                                   ((ap.sinks - am.sinks) / (2 * h)).numpy(),
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("synth", [True, False])
def test_reaction_subset_is_the_operator_with_other_rates_zero(synth,
                                                               monkeypatch):
    monkeypatch.setattr(bo, "USE_SYNTH_MASK", synth)
    b = pt.models.hog1p_5d()
    space = _space(b, [3, 4, 4, 4, 4, 6, 6])
    full = pt.BoxOperator(b.model, space)
    sub = pt.BoxOperator(b.model, space, enable_reactions=(5, 6, 2))
    assert full.synth_mask == sub.synth_mask == synth
    assert sub.props.num_reactions == 3 and sub.props.num_field_rows == 0
    p, _ = _stacked(space, 0, seed=4)
    y = pt.FspVector(p=torch.as_tensor(p[0]),
                     sinks=torch.zeros(7, dtype=torch.float64))
    c = b.model.coefficients(60.0)
    cz = torch.zeros_like(c)
    cz[[5, 6, 2]] = c[[5, 6, 2]]
    got = sub.action(60.0, y)
    want = full.action(60.0, y, c=cz)
    assert torch.equal(got.p, want.p) and torch.equal(got.sinks, want.sinks)
    assert torch.equal(sub.action(60.0, y, c=c).p, got.p)
    mask = space.mask_host.reshape(-1)
    np.testing.assert_allclose(
        sub.diagonal(60.0).numpy(),
        -sum(float(c[r]) * full.props.field(r).numpy() * mask
             for r in (5, 6, 2)), rtol=1e-15, atol=0)
    if not synth:
        assert sub.data().mask is full.data().mask    # one shared copy


@pytest.mark.parametrize("synth", [True, False])
def test_batched_plain_is_a_loop_of_single_calls(synth, monkeypatch):
    monkeypatch.setattr(bo, "USE_SYNTH_MASK", synth)
    b = pt.models.hog1p_5d()
    op = pt.BoxOperator(b.model, _space(b, [3, 4, 4, 4, 4, 6, 6]))
    p, _ = _stacked(op.space, 3, seed=5)
    P = torch.as_tensor(p)
    c, d = op.coefficients(60.0), op.data()
    n0 = dict(bk.KERNEL.launches)
    if synth:
        got = bk.box_action_synth_batched(c, P, op.props, d.bounds, op.geom)
        one = [bk.box_action_synth_reference(c, P[i], op.props, d.bounds,
                                             op.geom) for i in range(4)]
    else:
        got = bk.box_action_batched(c, P, d.mask, op.props, d.viol, op.geom)
        one = [bk.box_action_reference(c, P[i], d.mask, op.props, d.viol,
                                       op.geom) for i in range(4)]
    assert bk.KERNEL.launches == n0
    assert got[0].shape == (4, op.geom.n) and got[1].shape == (4, 7)
    assert torch.equal(got[0], torch.stack([o[0] for o in one]))
    assert torch.equal(got[1], torch.stack([o[1] for o in one]))
    out = torch.empty_like(P)
    again = op.action_batched(60.0, P, out=out)
    assert again[0] is out and torch.equal(out, got[0])
    assert torch.equal(again[1], got[1])


def test_derivative_operators_share_the_base_mode_and_tables():
    """hog1p_5d_sens: every derivative propensity on a table (x1, x2, x3),
    and the derivative operators leave the synthesized-mask mode with the
    base operator."""
    b = pt.models.hog1p_5d_sens()
    sop = SensOperator(b.model, _space(b, [3, 4, 4, 4, 4, 6, 6]))
    subs = [o for o in sop.cxdA if o is not None]
    assert len(subs) == 2 and all(o is None for o in sop.dcxA)
    assert [o.enable_reactions for o in subs] == [(5, 6), (7,)]
    assert [o.props.axis for o in subs] == [(1, 2), (3,)]
    assert all(o.synth_mask for o in sop.sub_ops())
    # an epoch whose mask stops being constraint-only
    sop.base._synth_applies = lambda: False
    sop.refresh_data()
    assert not any(o.synth_mask for o in sop.sub_ops())
    assert all(o.data().mask is sop.base.data().mask for o in subs)
    assert sop.local_mv_flops() == 3 * sop.base.local_mv_flops()
