"""The box operator's propensity tables, the monotone constraint forms and
the synthesized-mask kernel's break masks, and the sharded action's
launches per matvec, on the CPU.

Each reaction whose propensity varies along one axis is a table along it
(a constant is a table of one entry), checked bitwise against the torch
propensity over the box; a reaction of two or more axes keeps a field row.
The plain versions rebuild the fields from the tables by broadcast, so
their ``dp`` is bitwise the field-reading action's and their sinks too
(the same sums in the same order).  Against the reference package's box
operator (its fused Pallas kernel in interpret mode, as its own CPU tests
run it) the action agrees within rtol 1e-12 / atol 1e-13 in float64.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.ops.box_operator import BoxOperator as JOp  # noqa: E402
from pacmensl_tpu.ops.vecops import FspVector as JVec  # noqa: E402
from pacmensl_tpu.statespace.box_space import BoxStateSpace as JBox  # noqa
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.ops import box_kernel as bk  # noqa: E402
from pacmensl_tpu_torch.ops import box_operator as bo  # noqa: E402
from pacmensl_tpu_torch.ops.stencil import coord_grid  # noqa: E402
from pacmensl_tpu_torch.parallel.halo_box import window_rows  # noqa: E402
from pacmensl_tpu_torch.parallel.mesh import StateMesh  # noqa: E402
from pacmensl_tpu_torch.statespace.constraints import (  # noqa: E402
    ConstraintForm, coord, form_values, gated, linear, product)

TOL = dict(rtol=1e-12, atol=1e-13)

BUNDLES = [                       # (bundle, bounds, reactions on field rows)
    ("poisson", [50], ()),
    ("toggle", [12, 9, 40], ()),
    ("repressilator", [25, 15, 15, 60, 30, 60], ()),
    ("hog1p_3d", [3, 8, 8, 4, 12, 12, 12], ()),
    ("hog1p_5d", [3, 6, 6, 6, 6, 8, 8], ()),
    ("transcr_reg_6d", [10, 6, 2, 3, 2, 4], (4, 6)),
]


def _operator(name, bounds, mesh=None):
    b = pt.models.ALL_MODELS[name]()
    cs = pt.ConstraintSet(b.constraint, np.asarray(bounds),
                          b.expansion_factors, b.model.num_species)
    space = pt.BoxStateSpace(b.model.stoichiometry, cs, b.x0, device="cpu",
                             pad_quanta=None if mesh is None else
                             [mesh.size] + [1] * (b.model.num_species - 1))
    return b, pt.BoxOperator(b.model, space, mesh=mesh)


def _k1_data(op):
    return (op.space.mask.reshape(-1).to(torch.uint8),
            bo.violation_bits(op.space.constraints, op.model.stoichiometry,
                              op.shape, "cpu"))


@pytest.mark.parametrize("name,bounds,rows", BUNDLES)
def test_tables_found_and_bitwise_the_fields(name, bounds, rows):
    b, op = _operator(name, bounds)
    pp = op.props
    assert tuple(r for r, ax in enumerate(pp.axis)
                 if ax == bk.FIELD_ROW) == rows
    assert pp.num_field_rows == len(rows)
    assert op._prop_fields is None          # the action needs no fields
    assert torch.equal(pp.dense(), op.prop_fields)
    for r, ax in enumerate(pp.axis):
        assert torch.equal(pp.field(r), op.prop_fields[r])
        if ax == bk.CONST_AXIS:
            assert pp.tables[r].numel() == 1
        elif ax >= 0:
            assert pp.tables[r].numel() == op.shape[ax]
    assert pp.table_bytes() == 8 * pp.packed.numel()
    assert pp.field_bytes() == 8 * len(rows) * op.geom.n


def test_two_axis_propensity_keeps_a_field_row():
    """A propensity that is constant along the slices through the origin
    but not over the box fails the bitwise check and keeps a field row, as
    does a NaN."""
    stoich = np.array([[1, 0], [0, 1], [-1, 0]])

    def prop(x, r):
        if r == 0:
            return x[:, 0] * x[:, 1]               # 0 on both slices
        if r == 1:
            return torch.where(x[:, 1] > 2, torch.nan, 1.0 + 0 * x[:, 1])
        return 0.5 * x[:, 0]
    model = pt.Model(stoich, prop)
    pp = bo.propensity_tables(model, (5, 6), "cpu")
    assert pp.axis == (bk.FIELD_ROW, bk.FIELD_ROW, 0)
    want = bo.propensity_fields(model, (5, 6), "cpu")
    assert torch.allclose(pp.fields, want[:2], rtol=0, atol=0,
                          equal_nan=True)
    assert torch.equal(pp.field(2), want[2])


def _mesh(rank, size):
    return StateMesh(None, rank, size, "cpu")


@pytest.mark.parametrize("name,bounds", [
    ("repressilator", [31, 7, 7, 99, 21, 99]),
    ("transcr_reg_6d", [11, 6, 2, 3, 2, 4])])
def test_tables_on_a_window_at_global_coordinates(name, bounds):
    """A rank's window (halo rows outside the box included): the tables'
    broadcast is bitwise the fields the torch propensity gives at global
    coordinates, 0 on rows outside the box; so is the whole box's
    propensities cut to the window."""
    _, whole = _operator(name, bounds, _mesh(0, 1))
    for rank in range(4):
        _, op = _operator(name, bounds, _mesh(rank, 4))
        sh = op.sharded
        want = bo.propensity_fields(op.model, sh.window_shape, "cpu",
                                    origin0=sh.origin0, g0=op.shape[0])
        assert torch.equal(op.props.dense(), want)
        assert torch.equal(op.prop_fields, want)
        full = bo.propensity_tables(op.model, op.shape, "cpu")
        cut = full.window(sh.origin0, sh.window_shape[0])
        assert torch.equal(cut.dense(), want)
    assert whole.props.shape == whole.sharded.window_shape


@pytest.mark.parametrize("name,bounds,rows", BUNDLES)
def test_plain_action_on_tables_is_the_field_action(name, bounds, rows):
    """Both plain versions with the tables and field rows give the
    field-reading action's dp and sinks bitwise, on the box and on a K4
    window."""
    b, op = _operator(name, bounds)
    mask, viol = _k1_data(op)
    rng = np.random.default_rng(4)
    p = torch.as_tensor(rng.random(op.geom.n)) * mask
    c = b.model.coefficients(30.0)
    got = bk.box_action(c, p, mask, op.props, viol, op.geom)
    want = bk.box_action(c, p, mask, op.prop_fields, viol, op.geom)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if op.synth_mask:
        b3 = op.data().bounds
        got3 = bk.box_action_synth(c, p, op.props, b3, op.geom)
        want3 = bk.box_action_synth(c, p, op.prop_fields, b3, op.geom)
        assert torch.equal(got3[0], want3[0])
        assert torch.equal(got3[1], want3[1])
        assert torch.equal(got3[0], got[0]) and torch.equal(got3[1], got[1])
    # the second of three axis-0 slabs, with a halo plane each side
    g, shape = op.geom, op.shape
    if shape[0] < 6 or len(shape) < 2:
        return
    w0 = int(np.abs(g.stoich[:, 0]).max()) + 1
    lo, hi = shape[0] // 3, 2 * shape[0] // 3
    o, L = lo - w0, hi - lo + 2 * w0
    gw = bk.BoxGeometry((L,) + shape[1:], g.stoich, g.nc, g.form, origin0=o,
                        g0=shape[0], out_rows=(w0, w0 + hi - lo))

    def win(t):
        return window_rows(t.reshape(shape), o, L).reshape(-1)
    pw = op.props.window(o, L)
    vw = torch.stack([win(v) for v in viol])
    got = bk.box_action(c, win(p), win(mask), pw, vw, gw)
    want = bk.box_action(c, win(p), win(mask), pw.dense(), vw, gw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    plane = int(np.prod(shape[1:]))
    whole = bk.box_action(c, p, mask, op.props, viol, op.geom)[0]
    assert torch.equal(got[0], whole[lo * plane:hi * plane])


@pytest.mark.parametrize("name,bounds,rows", BUNDLES)
def test_diagonal_from_tables_is_bitwise(name, bounds, rows):
    """diag(A(t)) from the tables, as today's formula computes it from the
    fields."""
    b, op = _operator(name, bounds)
    for t in (0.0, 45.0):
        c = b.model.coefficients(t).tolist()
        m = op.space.mask.reshape(-1)
        want = torch.zeros(op.geom.n, dtype=torch.float64)
        for r in range(b.model.num_reactions):
            want = want - c[r] * torch.where(
                m, op.prop_fields[r], torch.zeros((), dtype=torch.float64))
        assert torch.equal(op.diagonal(t), want)


def test_constraint_form_monotone():
    assert coord(2).monotone
    assert linear({1: 1, 3: 2}).monotone
    assert product(0, 1).monotone
    assert ConstraintForm().monotone
    assert not linear({0: -1}).monotone
    assert not product(0, 1, u=-2).monotone
    assert not gated(0, 1, linear({1: 1})).monotone
    h3 = pt.models.hog1p_3d().constraint.form
    assert [f.monotone for f in h3] == [True] * 3 + [False] * 4
    for name in ("repressilator", "hog1p_5d", "toggle"):
        assert all(f.monotone
                   for f in pt.models.ALL_MODELS[name]().constraint.form)


@pytest.mark.parametrize("name,bounds", [
    ("toggle", [12, 9, 40]), ("repressilator", [25, 15, 15, 60, 30, 60]),
    ("hog1p_3d", [3, 8, 8, 4, 12, 12, 12]),
    ("hog1p_5d", [3, 6, 6, 6, 6, 8, 8])])
def test_break_masks_are_exact(name, bounds):
    """Where every constraint holds at x, a constraint outside reaction r's
    source mask holds at every source x - s_r in the box, and one outside
    its target mask holds at x + s_r: the kernel may skip them."""
    b, op = _operator(name, bounds)
    form, stoich = op.geom.form, op.geom.stoich
    src, tgt = bk.synth_masks(form, stoich)
    bnd = torch.tensor(op.data().bounds)
    x = coord_grid(op.shape)
    ok = (form_values(form, x) <= bnd).all(dim=1)
    x = x[ok]
    hi = torch.as_tensor(op.shape)
    for r in range(stoich.shape[0]):
        s = torch.as_tensor(stoich[r])
        ys = x - s
        inbox = ((ys >= 0) & (ys < hi)).all(dim=1)
        over_s = form_values(form, ys[inbox]) > bnd
        over_t = form_values(form, x + s) > bnd
        for c in range(len(form)):
            if not (src[r] >> c) & 1:
                assert not bool(over_s[:, c].any()), (r, c)
            if not (tgt[r] >> c) & 1:
                assert not bool(over_t[:, c].any()), (r, c)
    # monotone forms prune: the repressilator's births test nothing at
    # their source, its deaths nothing at their target
    if name == "repressilator":
        assert src[0::2] == (0, 0, 0) and tgt[1::2] == (0, 0, 0)


def test_kernel_form_limits_on_the_last_axis():
    """K3 takes a form only where it is linear along the last axis on
    every row: no product of the last axis with itself, no gate on it."""
    stoich = np.array([[1, 0, 0], [0, 0, -1]])
    assert bk.form_fits_kernel((product(0, 2), coord(2)), stoich)
    assert not bk.form_fits_kernel((product(2, 2),), stoich)
    assert not bk.form_fits_kernel((gated(2, 1, coord(0)),), stoich)
    assert bk.form_fits_kernel((gated(0, 1, coord(2)),), stoich)


def _jax_pair(name, bounds):
    jb = pm.models.ALL_MODELS[name]()
    tb = pt.models.ALL_MODELS[name]()
    jcs = pm.ConstraintSet(jb.constraint, bounds, jb.expansion_factors)
    tcs = pt.ConstraintSet(tb.constraint, bounds, tb.expansion_factors)
    js = JBox(jb.model.stoichiometry, jcs, jb.x0)
    ts = pt.BoxStateSpace(tb.model.stoichiometry, tcs, tb.x0, device="cpu")
    jop = JOp(jb.model, js, dtype=jnp.float64, use_pallas=True)
    assert jop._pallas is not None
    return jop, pt.BoxOperator(tb.model, ts), js


@pytest.mark.parametrize("name,bounds,t", [
    ("repressilator", [22, 4, 4, 44, 8, 44], 0.0),
    ("hog1p_5d", [3, 4, 4, 4, 4, 6, 6], 60.0)])
def test_action_on_tables_matches_the_reference_package(name, bounds, t):
    jop, top, js = _jax_pair(name, np.asarray(bounds))
    assert top.props.num_field_rows == 0 and top._prop_fields is None
    rng = np.random.default_rng(9)
    p = np.where(js.mask_host, rng.random(js.shape), 0.0)
    nc = js.num_constraints
    want = jop.action(t, JVec(p=jnp.asarray(p), sinks=jnp.zeros(nc)))
    got = top.action(t, pt.FspVector(
        p=torch.as_tensor(p.reshape(-1)),
        sinks=torch.zeros(nc, dtype=torch.float64)))
    np.testing.assert_allclose(got.p.numpy(),
                               np.asarray(want.p).reshape(-1), **TOL)
    np.testing.assert_allclose(got.sinks.numpy(), np.asarray(want.sinks),
                               **TOL)
    np.testing.assert_allclose(top.diagonal(t).numpy(),
                               np.asarray(jop.diagonal(t)).reshape(-1),
                               **TOL)


@pytest.mark.parametrize("synth", [True, False])
def test_one_rank_sharded_matvec_is_one_call(synth, monkeypatch):
    """With one rank no halo is in flight: one call of the plain version
    per matvec on the slab, no exchange, no collective, and the whole
    box's dp and sinks bitwise."""
    monkeypatch.setattr(bo, "USE_SYNTH_MASK", synth)
    b, one = _operator("repressilator", [31, 7, 7, 99, 21, 99])
    mesh = _mesh(0, 1)
    mesh.halo_start = mesh.all_reduce = None     # never called
    sh = pt.BoxOperator(b.model, one.space, mesh=mesh)
    assert not sh.sharded.halos and sh.sharded.L0 >= 2 * sh.sharded.w0
    rng = np.random.default_rng(2)
    p = torch.as_tensor(rng.random(one.geom.n)) * one.space.mask.reshape(-1)
    y = pt.FspVector(p=p, sinks=torch.zeros(6, dtype=torch.float64))
    want = one.action(0.0, y)
    key = "sharded_synth" if synth else "sharded_mask"
    n0 = dict(bk.KERNEL.plain_calls)
    got = sh.action(0.0, y)
    assert bk.KERNEL.plain_calls[key] == n0[key] + 1
    assert sum(bk.KERNEL.plain_calls.values()) == sum(n0.values()) + 1
    assert torch.equal(got.p, want.p) and torch.equal(got.sinks, want.sinks)


@pytest.mark.parametrize("out_rows", [(2, 10), (2, 6), (6, 10), (4, 8),
                                      (3, 4), (2, 2)])
@pytest.mark.parametrize("origin0", [-2, 0, 5, 10])
def test_read_spans_hold_the_rows_a_window_reads(out_rows, origin0):
    """A K4 window's read spans are the rows its computed rows and their
    sources along axis 0 reach inside the global box (the rows whose p
    the bound counts), and the halos are read where they leave p's rows."""
    stoich = np.array([[1, 0], [-1, 0], [2, 0], [0, 1], [0, -1]])
    g0, (lo, hi) = 20, out_rows
    g = bk.BoxGeometry((12, 5), stoich, 0, origin0=origin0, g0=g0,
                       out_rows=out_rows, halo_rows=(lo, hi - lo))
    want = {r - s for r in range(lo, hi)
            for s in (0, 1, -1, 2) if 0 <= r - s + origin0 < g0}
    got = [r for a, b in g.read_spans for r in range(a, b)]
    assert set(got) == want
    assert g.reads_halo == (any(r < lo for r in want),
                            any(r >= hi for r in want))
