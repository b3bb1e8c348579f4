"""The synthesized-mask mode of the box kernel (the TPU kernel's K3,
``synth_mask=True``) and the constraint forms it evaluates.

* Every bundle's form gives its constraint components' scores on seeded
  points (numpy, fixed seed), and a form that disagrees with its function
  is refused when the constraint set is built.
* The port's K3 plain version against the reference package's K3 in
  interpret mode (``BoxOperator(use_pallas=True)`` on a constraint-only
  mask, as ``tests/test_pallas.py`` runs it), at rtol 1e-12 / atol 1e-13.
* Mode selection and downgrade, as the reference package chooses them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.ops.box_operator import BoxOperator as JOp  # noqa: E402
from pacmensl_tpu.ops.vecops import FspVector as JVec  # noqa: E402
from pacmensl_tpu.statespace.box_space import BoxStateSpace as JBox  # noqa: E402
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.ops import box_kernel as bk  # noqa: E402
from pacmensl_tpu_torch.ops import box_operator as bo  # noqa: E402
from pacmensl_tpu_torch.statespace.constraints import (  # noqa: E402
    coord, form_values, linear, product)

TOL = dict(rtol=1e-12, atol=1e-13)
CUSTOM = ["toggle", "repressilator", "hog1p_3d", "hog1p_5d"]


@pytest.mark.parametrize("name", CUSTOM)
def test_bundle_form_matches_components(name):
    b = pt.models.ALL_MODELS[name]()
    S = b.model.num_species
    hi = 3 * int(np.max(b.bounds))
    rng = np.random.default_rng(7)
    pts = np.concatenate([rng.integers(-1, hi, size=(500, S)),
                          rng.integers(-1, 5, size=(500, S))])
    x = torch.as_tensor(pts)
    want = torch.stack([c(x) for c in b.constraint.components], dim=1)
    got = form_values(b.constraint.form, x)
    assert torch.equal(got, want.to(torch.int64))
    assert torch.equal(got, b.constraint(x).to(torch.int64))


def test_coordinate_constraints_get_a_form():
    cs = pt.ConstraintSet(None, [4, 5, 6], None, 3)
    assert cs.form == (coord(0), coord(1), coord(2))
    x = torch.as_tensor(np.random.default_rng(1).integers(0, 9, (50, 3)))
    assert torch.equal(cs.form_values(x), x)


def test_wrong_form_is_refused():
    def fn(x):
        return torch.stack([x[:, 0], x[:, 0] * x[:, 1]], dim=1)

    fn.form = (coord(0), product(0, 1))
    pt.ConstraintSet(fn, [5, 20])                      # right: accepted
    fn.form = (coord(0), linear({0: 1, 1: 1}))         # sum, not product
    with pytest.raises(pt.StateSpaceError, match="disagrees"):
        pt.ConstraintSet(fn, [5, 20])
    fn.form = (coord(0),)                              # one entry short
    with pytest.raises(pt.StateSpaceError, match="entries"):
        pt.ConstraintSet(fn, [5, 20])


def _birth_model():
    """x0 grows by 1 and by 2 at constant rates."""
    return pt.Model(np.array([[1], [2]]),
                    lambda x, r: torch.full_like(x[:, 0], 1.0 + r,
                                                 dtype=torch.float64))


def test_form_that_disagrees_inside_the_box_is_refused(monkeypatch):
    """The form is checked against its function only on seeded points at
    construction; the operator compares the mask the form gives with the
    space's over the whole box, when it selects the synthesized mask and
    at every later epoch, and raises on a difference."""
    def fn(x):          # x0, except that x0 = 7 scores 100
        return (x[:, :1] + 93 * (x[:, :1] == 7)).to(torch.int64)

    fn.form = (coord(0),)
    with pytest.raises(pt.StateSpaceError, match="disagrees"):
        pt.ConstraintSet(fn, [9])        # the seeded points include 7
    # a form the construction check missed
    monkeypatch.setattr(pt.ConstraintSet, "_check_form", lambda self: None)
    model = _birth_model()
    space = pt.BoxStateSpace(model.stoichiometry, pt.ConstraintSet(fn, [6]),
                             [[0]], device="cpu")
    op = pt.BoxOperator(model, space)     # both exclude 7 at bound 6
    assert op.synth_mask and space.shape[0] > 8
    shape0 = space.shape
    space.set_bounds(np.array([8]))       # the form admits 7, fn does not
    assert space.shape == shape0
    assert space.mask_is_constraint_only and not bool(space.mask[7])
    with pytest.raises(pt.StateSpaceError, match="disagrees"):
        op.refresh_data()
    with pytest.raises(pt.StateSpaceError, match="disagrees"):
        pt.BoxOperator(model, space)


def _pair(name, bounds):
    jb, tb = pm.models.ALL_MODELS[name](), pt.models.ALL_MODELS[name]()
    js = JBox(jb.model.stoichiometry,
              pm.ConstraintSet(jb.constraint, bounds, jb.expansion_factors),
              jb.x0)
    ts = pt.BoxStateSpace(
        tb.model.stoichiometry,
        pt.ConstraintSet(tb.constraint, bounds, tb.expansion_factors),
        tb.x0, device="cpu")
    jop = JOp(jb.model, js, dtype=jnp.float64, use_pallas=True)
    assert jop._pallas is not None and jop._pallas.synth_mask
    top = pt.BoxOperator(tb.model, ts)
    assert top.synth_mask and top.data().mask is None
    return jop, top, js


def _compare(jop, top, js, t, seed):
    rng = np.random.default_rng(seed)
    p = np.where(js.mask_host, rng.random(js.shape), 0.0)
    n_c = js.num_constraints
    want = jop.action(t, JVec(p=jnp.asarray(p), sinks=jnp.zeros(n_c)))
    got = top.action(t, pt.FspVector(
        p=torch.as_tensor(p.reshape(-1)),
        sinks=torch.zeros(n_c, dtype=torch.float64)))
    np.testing.assert_allclose(got.p.numpy(),
                               np.asarray(want.p).reshape(-1), **TOL)
    np.testing.assert_allclose(got.sinks.numpy(), np.asarray(want.sinks),
                               **TOL)
    assert np.abs(np.asarray(want.sinks)).max() > 0   # sinks exercised


@pytest.mark.parametrize("name,bounds,times", [
    ("toggle", [12, 9, 40], [0.0]),
    ("repressilator", [22, 2, 2, 44, 4, 44], [0.0]),
    ("hog1p_3d", [3, 4, 4, 1, 10, 10, 10], [0.0, 30.0, 120.0]),
    ("hog1p_5d", [3, 6, 6, 6, 6, 8, 8], [0.0, 60.0]),
])
def test_synth_action_matches_reference_k3(name, bounds, times):
    jop, top, js = _pair(name, np.asarray(bounds))
    for i, t in enumerate(times):
        _compare(jop, top, js, t, seed=i)


def test_synth_action_after_bounds_change_in_capacity():
    jop, top, js = _pair("toggle", np.array([16, 9, 40]))
    shape0 = tuple(js.shape)
    new = np.array([18, 9, 41])
    js.set_bounds(new)
    top.space.set_bounds(new)
    assert tuple(js.shape) == shape0 == tuple(top.space.shape)
    jop.refresh_data()
    top.refresh_data()
    assert top.synth_mask and jop._pallas.synth_mask
    _compare(jop, top, js, 0.0, seed=3)


def _k1_action(op, t, p):
    mask = op.space.mask.reshape(-1).to(torch.uint8)
    viol = bo.violation_bits(op.space.constraints, op.model.stoichiometry,
                             op.shape, op.device)
    return bk.box_action(op.model.coefficients(t), p, mask, op.prop_fields,
                         viol, op.geom)


def test_synth_plain_version_is_the_mask_reading_one():
    """On a constraint-only mask both plain versions give the same dp and
    sinks, bit for bit (the CUDA kernels are held to the same)."""
    b = pt.models.repressilator()
    cs = pt.ConstraintSet(b.constraint, [25, 15, 15, 60, 30, 60],
                          b.expansion_factors)
    op = pt.BoxOperator(b.model, pt.BoxStateSpace(b.model.stoichiometry, cs,
                                                  b.x0, device="cpu"))
    assert op.synth_mask
    rng = np.random.default_rng(4)
    p = torch.as_tensor(rng.random(op.geom.n)) * op.space.mask.reshape(-1)
    got = op.action(0.0, pt.FspVector(p=p, sinks=torch.zeros(6,
                                                            dtype=p.dtype)))
    dp, sk = _k1_action(op, 0.0, p)
    assert torch.equal(got.p, dp) and torch.equal(got.sinks, sk)


def test_mode_selection():
    # pruned by reachability: the mask-reading mode, as in the reference
    b = pt.models.transcription_regulation_6d()
    cs = pt.ConstraintSet(None, [10, 6, 2, 3, 2, 4], None, 6)
    op = pt.BoxOperator(b.model, pt.BoxStateSpace(b.model.stoichiometry, cs,
                                                  b.x0, device="cpu"))
    assert not op.space.mask_is_constraint_only
    assert not op.synth_mask and op.data().mask is not None
    # a custom constraint function without a form
    tg = pt.models.toggle()

    def fn(x):
        return tg.constraint(x)

    fn.components = tg.constraint.components
    cs = pt.ConstraintSet(fn, [12, 9, 40])
    assert cs.form is None
    op = pt.BoxOperator(tg.model, pt.BoxStateSpace(tg.model.stoichiometry,
                                                   cs, tg.x0, device="cpu"))
    assert op.space.mask_is_constraint_only and not op.synth_mask


def test_mode_selection_switch(monkeypatch):
    tg = pt.models.toggle()
    cs = pt.ConstraintSet(tg.constraint, [12, 9, 40])
    space = pt.BoxStateSpace(tg.model.stoichiometry, cs, tg.x0, device="cpu")
    assert pt.BoxOperator(tg.model, space).synth_mask
    monkeypatch.setattr(bo, "USE_SYNTH_MASK", False)
    assert not pt.BoxOperator(tg.model, space).synth_mask


def test_downgrade_when_the_mask_stops_being_constraint_only():
    """A bound growth that admits unreachable states switches the operator
    to the mask-reading mode for good (reference box_operator.py:379-386);
    its action then equals a fresh mask-reading operator's."""
    model = pt.Model(np.array([[1, 0]]),
                     lambda x, r: torch.full_like(x[:, 0], 2.0,
                                                  dtype=torch.float64))
    cs = pt.ConstraintSet(None, [6, 0], [0.5, 1.0], 2)
    space = pt.BoxStateSpace(model.stoichiometry, cs, [[0, 0]], device="cpu")
    op = pt.BoxOperator(model, space)
    assert space.mask_is_constraint_only and op.synth_mask
    shape0 = space.shape
    space.set_bounds(np.array([6, 1]))      # x1 = 1 is allowed, unreachable
    assert space.shape == shape0 and not space.mask_is_constraint_only
    op.refresh_data()
    assert not op.synth_mask and op.data().mask is not None
    rng = np.random.default_rng(9)
    p = torch.as_tensor(rng.random(op.geom.n)) * space.mask.reshape(-1)
    got = op.action(0.0, pt.FspVector(p=p, sinks=torch.zeros(
        2, dtype=p.dtype)))
    dp, sk = _k1_action(op, 0.0, p)
    assert torch.equal(got.p, dp) and torch.equal(got.sinks, sk)
    space.set_bounds(np.array([6, 0]))      # constraint-only again: no
    op.refresh_data()                       # upgrade within the operator
    assert space.mask_is_constraint_only and not op.synth_mask
