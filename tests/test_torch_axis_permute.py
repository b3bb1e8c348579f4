"""The box's species-axis order on the port (``statespace/permute.py``),
held against the reference package's (``tests/test_axis_permute.py``).

* ``choose_axis_order`` is the reference's, ties included.
* The permuted model, constraint set, forms, components and derivative
  propensities evaluate at internal coordinates as the user's do at user
  coordinates, and as the reference's permuted ones do.
* A box solve takes the reference's axis order at set-up and at every
  reordered rebuild, in the same epoch, and returns the same user-order
  states; the rebuild carries p (and every s_j) bit for bit by state.
* The stale-order check does not fire on tied extents whose order holds
  (the reference's does: it derives the order from internal extents).
* A permuted box migrating to the compressed backend returns user-order
  states.

Tolerances: orders, states, bounds and epoch counts exactly; evaluations
bitwise; distributions within the stated total variation.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.statespace import permute as jperm  # noqa: E402
from pacmensl_tpu.statespace.constraints import (  # noqa: E402
    ConstraintSet as JCS)
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.statespace import permute as tperm  # noqa: E402


def _order(o, S):
    return list(range(S)) if o is None else np.asarray(o).tolist()


def test_choose_axis_order_matches_reference():
    """The cases of ``tests/test_axis_permute.py:21-30``, the ties of
    the repressilator, hog1p_5d and 11e's box, and 200 seeded extent
    vectors with many ties."""
    cases = [[5, 2, 3], [2, 9, 4], [3, 7, 7], [4, 50, 60, 40, 45],
             [316, 211, 211], [94, 42, 4, 42, 63], [13, 13, 4, 13, 13],
             [4, 13, 13, 13, 13], [7], [3, 3]]
    rng = np.random.default_rng(11)
    for _ in range(200):
        S = int(rng.integers(1, 7))
        hi = int(rng.choice([4, 9, 300]))
        cases.append(rng.integers(1, hi, size=S).tolist())
    for ext in cases:
        assert _order(tperm.choose_axis_order(ext), len(ext)) == \
            _order(jperm.choose_axis_order(ext), len(ext)), ext
    # the reference's fault, kept: not idempotent on ties
    assert tperm.choose_axis_order([316, 211, 211]).tolist() == [0, 2, 1]


def _evaluations(pkg, name, order, x_user, sens=False):
    """Propensities, constraint values, components (and derivative
    propensities) of bundle ``name`` at ``x_user`` by the user's
    callables and at ``x_user[:, order]`` by the permuted ones."""
    b = getattr(pkg.models, name)()
    perm = pkg is pt and tperm or jperm
    S = b.model.num_species
    arr = ((lambda x: torch.as_tensor(x)) if pkg is pt
           else (lambda x: jnp.asarray(x)))
    xu, xi = arr(x_user), arr(x_user[:, order])
    model = perm.permute_model(b.model, order)
    CS = pt.ConstraintSet if pkg is pt else JCS
    cs = CS(b.constraint, b.bounds, b.expansion_factors, S)
    pcs = perm.permute_constraints(cs, order, S)
    out = {"stoich": (model.stoichiometry, b.model.stoichiometry[:, order]),
           "values": (pcs.values(xi), cs.values(xu))}
    for r in range(b.model.num_reactions):
        out[f"prop{r}"] = (model.propensity(xi, r), b.model.propensity(xu, r))
    for k, (c, cu) in enumerate(zip(pcs.components, cs.components)):
        out[f"comp{k}"] = (c(xi), cu(xu))
    if pkg is pt:
        out["form"] = (pcs.form_values(xi), cs.values(xu))
    if sens:
        for j in range(b.model.num_parameters):
            for r in b.model.dprop_sparsity[j]:
                out[f"dprop{j}_{r}"] = (model.d_propensity(xi, j, r),
                                        b.model.d_propensity(xu, j, r))
    return {k: (np.asarray(a), np.asarray(u)) for k, (a, u) in out.items()}


@pytest.mark.parametrize("name,order,sens", [
    ("hog1p_3d", [1, 2, 0], False),          # gated forms
    ("hog1p_5d", [2, 3, 0, 1, 4], False),    # linear forms
    ("repressilator", [0, 2, 1], False),     # product forms
    ("transcription_regulation_6d", [0, 1, 5, 3, 2, 4], False),  # default
    ("hog1p_5d_sens", [2, 3, 0, 1, 4], True),
])
def test_permuted_problem_evaluates_as_the_users(name, order, sens):
    """``tests/test_axis_permute.py:32-50`` on the port, plus the forms
    the kernel evaluates and the derivative propensities: every value
    bitwise the user's, and within 1e-15 relative of the reference's
    permuted one's (the two packages' propensities round apart)."""
    S = len(order)
    x_user = np.random.default_rng(3).integers(0, 5, size=(50, S))
    got = _evaluations(pt, name, order, x_user, sens)
    ref = _evaluations(pm, name, order, x_user, sens)
    for k, (perm_v, user_v) in got.items():
        np.testing.assert_array_equal(perm_v, user_v, err_msg=k)
        if k in ref:     # the packages' arithmetic may differ by an ulp
            np.testing.assert_allclose(perm_v, ref[k][0], rtol=1e-15,
                                       atol=0, err_msg=k)
    # constraint outputs stay in user order: default constraints too
    b = getattr(pt.models, name)()
    pcs = tperm.permute_constraints(
        pt.ConstraintSet(b.constraint, b.bounds, b.expansion_factors, S),
        order, S)
    np.testing.assert_array_equal(pcs.bounds, b.bounds)


def test_permuted_set_rebuilt_from_its_function_stays_permuted():
    """A set rebuilt from the permuted function (``set_expansion_factors``
    does so) keeps the permuted form and components."""
    b = pt.models.hog1p_3d()
    cs = pt.ConstraintSet(b.constraint, b.bounds, b.expansion_factors, 3)
    pcs = tperm.permute_constraints(cs, [1, 2, 0], 3)
    again = pt.ConstraintSet(pcs.fn, pcs.bounds, None, 3)
    assert again.form == pcs.form
    x = torch.as_tensor(np.random.default_rng(0).integers(0, 5, (20, 3)))
    assert torch.equal(again.form_values(x), again.values(x))


# ------------------------------------------------------------ solves
class _JOrders:
    """The reference driver, recording ``(epoch, order)`` at each
    derivation of the box's axis order."""

    def _setup_axis_order(self):
        super()._setup_axis_order()
        ev = self.events.events.get("ODESolve")
        o = self._axis_order if self._axis_inv is not None else None
        self.orders = getattr(self, "orders", []) + [
            (ev.count if ev else 0, _order(o, self.model.num_species))]


class _TOrders:
    """The port's driver, checking at every reordered rebuild that each
    row of the solution keeps its values by state, bit for bit."""

    def _setup_axis_order(self):
        super()._setup_axis_order()
        ev = self.events.events.get("ODESolve")
        self.orders = getattr(self, "orders", []) + [
            (ev.count if ev else 0, self.axis_orders_[-1][1])]

    def _rebuild_box_reordered(self, *args):
        st0, rows0 = self._valid_rows()
        super()._rebuild_box_reordered(*args)
        st1, rows1 = self._valid_rows()
        at = {tuple(x): i for i, x in enumerate(st1)}
        idx = np.array([at[tuple(x)] for x in st0])
        self.carried = getattr(self, "carried", []) + [
            bool(np.array_equal(rows1[:, idx], rows0))
            and not rows1[:, np.setdiff1d(np.arange(len(st1)), idx)].any()]


def _hog3(pkg, cls):
    b = pkg.models.hog1p_3d()
    s = cls(backend="box", odes_type="cvode",
            **({"device": "cpu"} if pkg is pt else {}))
    s.set_model(b.model)
    s.set_constraint_functions(b.constraint)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors(b.expansion_factors)
    s.set_initial_distribution(b.x0, b.p0)
    return s


def test_hog1p_3d_box_takes_the_reference_order():
    """``tests/test_axis_permute.py:53`` on the port: the gene axis
    (extent 4) leaves axis 0; the orders, states, bounds and epochs are
    the reference's, the states in user order and in the reference's row
    order; total variation <= 1e-6 (rounding of the two BDF solves)."""
    js = _hog3(pm, type("J", (_JOrders, pm.FspSolverMultiSinks), {}))
    jd = js.solve(3.0, 1e-4)
    ts = _hog3(pt, type("T", (_TOrders, pt.FspSolverMultiSinks), {}))
    td = ts.solve(3.0, 1e-4)
    assert ts.orders == js.orders
    assert ts.orders[0][1] == [1, 0, 2]
    assert ts._space.shape[0] == max(ts._space.shape)
    assert tuple(ts._space.shape) == tuple(js._space.shape)
    np.testing.assert_array_equal(td.states, jd.states)
    np.testing.assert_array_equal(td.bounds, jd.bounds)
    assert ts.events.events["ODESolve"].count == \
        js.events.events["ODESolve"].count
    assert 0.5 * np.abs(td.p - jd.p).sum() <= 1e-6
    # restart from the permuted solve's own (user-order) output
    s3 = _hog3(pt, pt.FspSolverMultiSinks)
    s3.set_initial_distribution(td)
    assert abs(s3.solve(3.5, 1e-4, t_init=3.0).sum() - 1.0) < 1e-3


_STOICH = np.array([[1, 0], [-1, 0], [0, 1], [0, -1]])


def _aniso_prop(pkg):
    """Species A capped at 12, B born fast: B's bound outgrows A's
    mid-solve and the descending order flips (``test_axis_permute.py:
    92``), float64 in both packages."""
    if pkg is pt:
        def prop(x, r):
            xf = x.to(torch.float64)
            rate = (0.3, 0.5 * xf[:, 0], 6.0, 0.4 * xf[:, 1])[r]
            return rate * torch.ones_like(xf[:, 0])
    else:
        def prop(x, r):
            xf = x.astype(jnp.float64)
            rate = (0.3, 0.5 * xf[:, 0], 6.0, 0.4 * xf[:, 1])[r]
            return rate * jnp.ones_like(xf[:, 0])
    return prop


def _aniso(pkg, cls, model, solver_kw=None):
    s = cls(backend="box", odes_type="krylov", **(solver_kw or {}))
    s.set_model(model)
    s.set_initial_bounds([12, 4])
    s.set_expansion_factors([0.0, 0.6])
    s.set_initial_distribution(np.array([[0, 0]]), np.array([1.0]))
    return s, s.solve(6.0, 1e-6)


def test_mid_solve_reorder_matches_reference():
    """The order flips in the same epoch as the reference's, p is
    carried bitwise by state, and the result is the reference's: the
    same states in the same rows, total variation <= 1e-7 (measured
    4.2e-8: the two Krylov integrators' step sizes round apart)."""
    js, jd = _aniso(pm, type("J", (_JOrders, pm.FspSolverMultiSinks), {}),
                    pm.Model(_STOICH, _aniso_prop(pm)))
    ts, td = _aniso(pt, type("T", (_TOrders, pt.FspSolverMultiSinks), {}),
                    pt.Model(_STOICH, _aniso_prop(pt)), {"device": "cpu"})
    assert td.bounds[1] > 12
    assert ts.orders == js.orders
    assert [o for _, o in ts.orders] == [[0, 1], [1, 0]]
    assert ts.carried == [True]
    assert ts.events.events["BoxReorder"].count == 1
    np.testing.assert_array_equal(td.states, jd.states)
    np.testing.assert_array_equal(td.bounds, jd.bounds)
    assert 0.5 * np.abs(td.p - jd.p).sum() <= 1e-7


def _sens_model(pkg):
    """The anisotropic model with one parameter, B's birth rate."""
    prop = _aniso_prop(pkg)
    ones = ((lambda c: torch.ones_like(c, dtype=torch.float64))
            if pkg is pt else (lambda c: jnp.ones_like(c, jnp.float64)))

    def d_prop(x, j, r):
        v = ones(x[:, 1])
        return v if (j, r) == (0, 2) else 0.0 * v
    return pkg.SensModel(_STOICH, prop, num_parameters=1, d_propensity=d_prop,
                         dprop_sparsity=((2,),), d_t_coeff=None,
                         dtcoef_sparsity=())


def test_sens_mid_solve_reorder_matches_reference():
    """``test_axis_permute.py:135`` on the port: p and dp cross the
    reorder by the same map, bit for bit by state, and match the
    reference's box solve (p within 1e-7 in total variation, measured
    2.0e-8, and dp within 1e-8 absolute)."""
    from pacmensl_tpu.sensfsp.sens_solver import SensFspSolverMultiSinks
    js, jd = _aniso(pm, type("J", (_JOrders, SensFspSolverMultiSinks), {}),
                    _sens_model(pm))
    ts, td = _aniso(pt, type("T", (_TOrders, pt.SensFspSolverMultiSinks),
                             {}), _sens_model(pt), {"device": "cpu"})
    assert ts.orders == js.orders
    assert ts.carried == [True]
    np.testing.assert_array_equal(td.states, jd.states)
    assert 0.5 * np.abs(td.p - jd.p).sum() <= 1e-7
    np.testing.assert_allclose(td.dp, jd.dp, rtol=0, atol=1e-8)


def test_tied_extents_keep_their_order():
    """The repressilator's box ties its two short axes: both packages lay
    it out as [0, 2, 1].  Growing within that order outgrows the capacity
    without a reorder on the port; the reference's condition (a), which
    derives the order from internal extents, reports it stale.  Growth
    that changes the order still reorders."""
    def solver(pkg):
        b = pkg.models.repressilator()
        s = pkg.FspSolverMultiSinks(
            backend="box", odes_type="krylov",
            **({"device": "cpu"} if pkg is pt else {}))
        s.set_model(b.model)
        s.set_constraint_functions(b.constraint)
        s.set_initial_bounds(b.bounds)
        s.set_expansion_factors(b.expansion_factors)
        s.set_initial_distribution(b.x0, b.p0)
        return s.set_up(), b
    ts, b = solver(pt)
    js, _ = solver(pm)
    assert ts.axis_orders_ == [(None, [0, 2, 1])]
    assert js._axis_order.tolist() == [0, 2, 1]
    tied = b.bounds * 4            # all extents grow, the ties stay
    assert ts._box_reorder_needed(tied) is False
    assert js._box_reorder_needed(tied) is True
    lop = b.bounds.copy()
    lop[[1, 3, 4]] *= 40           # species 1 outgrows species 0
    assert ts._box_reorder_needed(lop) is True


def test_permuted_box_migrates_with_user_order_states(monkeypatch):
    """The anisotropic solve reorders its box, then outgrows a budget of
    500 box elements (Krylov's 62 vectors) and migrates to the compressed
    backend: its states come back in user order (A, capped at 12, in
    column 0) and are those of the box-only solve, total variation
    <= 1e-8 (the backends sum in other orders)."""
    monkeypatch.setenv("PACMENSL_BOX_MEM_BUDGET", str(500 * 62 * 8))
    s, d = _aniso(pt, type("T", (_TOrders, pt.FspSolverMultiSinks), {}),
                  pt.Model(_STOICH, _aniso_prop(pt)), {"device": "cpu"})
    assert [o for _, o in s.orders] == [[0, 1], [1, 0]]
    assert s.carried == [True]
    assert s._backend_used == "ell" and s._axis_inv is None
    assert s.constraints.fn is None
    monkeypatch.delenv("PACMENSL_BOX_MEM_BUDGET")
    _, db = _aniso(pt, pt.FspSolverMultiSinks,
                   pt.Model(_STOICH, _aniso_prop(pt)), {"device": "cpu"})
    a = {tuple(x): p for x, p in zip(d.states, d.p)}
    b = {tuple(x): p for x, p in zip(db.states, db.p)}
    assert set(a) == set(b)
    assert d.states[:, 0].max() == 12 and d.states[:, 1].max() > 12
    assert 0.5 * sum(abs(a[k] - b[k]) for k in a) <= 1e-8


def test_setters_restore_the_users_constraints():
    """After a permuted solve, set-up, ``clear_state`` and the setters
    return the user's constraint function, never a wrapped one, and a
    second solve takes the same order again."""
    b = pt.models.hog1p_3d()
    s = _hog3(pt, pt.FspSolverMultiSinks)
    d1 = s.solve(1.0, 1e-4)
    assert s.constraints.fn is not b.constraint          # permuted
    s.clear_state()
    assert s.constraints.fn.__code__ is b.constraint.__code__
    s.set_expansion_factors(b.expansion_factors)
    d2 = s.solve(1.0, 1e-4)
    assert s.axis_orders_[0] == (None, [1, 0, 2])
    np.testing.assert_array_equal(d1.states, d2.states)
    np.testing.assert_array_equal(d1.p, d2.p)
    s.set_initial_bounds(b.bounds)
    assert s.constraints.fn.__code__ is b.constraint.__code__
