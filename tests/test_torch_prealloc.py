"""Eager box capacity on the port (``BoxStateSpace(prealloc_budget=...)``,
``FspSolverMultiSinks(preallocate=...)``), held against the reference
package's (``tests/test_prealloc.py``).

* The water-filled capacity equals the reference's ``_prealloc_shape``,
  epoch after epoch, under both headroom policies; every epoch's mask
  equals a from-scratch ladder build.
* A budget too small for the box raises ``StateSpaceError``.
* ``preallocate=True`` takes the reference's growable axes and capacity
  (the reference with ``pallas=False``: its TPU halo cap ``minor_limit``
  is not ported); ``"auto"`` keeps the ladder on the host.
* A preallocated solve matches the ladder's (total variation stated).

Capacities, masks and state sets exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.statespace.box_space import (  # noqa: E402
    BoxStateSpace as JBox)
from pacmensl_tpu.statespace.constraints import (  # noqa: E402
    ConstraintSet as JCS)
from pacmensl_tpu.sys.errors import (  # noqa: E402
    StateSpaceError as JStateSpaceError)
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.sys.errors import StateSpaceError  # noqa: E402


def _spaces(b, bounds, budget):
    """The port's and the reference's preallocated repressilator boxes."""
    tcs = pt.ConstraintSet(b.constraint, bounds, b.expansion_factors)
    jcs = JCS(pm.models.repressilator().constraint, bounds,
              b.expansion_factors)
    return (pt.BoxStateSpace(b.model.stoichiometry, tcs, b.x0,
                             device="cpu", prealloc_budget=budget),
            JBox(b.model.stoichiometry, jcs, b.x0, prealloc_budget=budget,
                 build_on_device=True))


@pytest.mark.parametrize("headroom", ["0", None])
def test_waterfill_capacity_matches_reference(headroom, monkeypatch):
    """``tests/test_prealloc.py:20-72`` on the port: headroom 0 fills the
    budget (the growable axes share one cap and the capacity stays put),
    the default 8x headroom allocates less and grows monotonically; at
    every epoch the capacity is the reference's and the mask a ladder
    build's."""
    if headroom is None:
        monkeypatch.delenv("PACMENSL_BOX_HEADROOM", raising=False)
    else:
        monkeypatch.setenv("PACMENSL_BOX_HEADROOM", headroom)
    b = pt.models.repressilator()
    tsp, jsp = _spaces(b, b.bounds, 2.0e5)
    assert tsp.shape == jsp.shape and tsp.size <= 2.0e5
    if headroom == "0":
        assert len(set(tsp.shape)) == 1
    else:
        assert tsp.size < 1.0e5
    bounds, shape0, n0 = np.asarray(b.bounds), tsp.shape, tsp.num_states
    for _ in range(3):
        bounds = pt.ConstraintSet(b.constraint, bounds,
                                  b.expansion_factors).expanded_bounds(
                                      np.ones(len(bounds), bool))
        prev = tsp.shape
        tsp.set_bounds(bounds)
        jsp.set_bounds(bounds)
        assert tsp.shape == jsp.shape
        assert all(a >= c for a, c in zip(tsp.shape, prev))
        if headroom == "0":
            assert tsp.shape == shape0
        ref = pt.BoxStateSpace(
            b.model.stoichiometry,
            pt.ConstraintSet(b.constraint, bounds, b.expansion_factors),
            b.x0, device="cpu")
        assert tsp.num_states == ref.num_states == jsp.num_states
        assert set(map(tuple, tsp.states())) == set(map(tuple, ref.states()))
    assert tsp.num_states > n0


def test_budget_too_small_raises():
    b = pt.models.repressilator()
    cs = pt.ConstraintSet(None, np.array([100, 100, 100]), None)
    with pytest.raises(StateSpaceError, match="preallocation budget"):
        pt.BoxStateSpace(b.model.stoichiometry, cs, b.x0, device="cpu",
                         prealloc_budget=1.0e3)
    with pytest.raises(JStateSpaceError, match="preallocation budget"):
        JBox(b.model.stoichiometry, JCS(None, np.array([100, 100, 100]),
                                        None), b.x0, prealloc_budget=1.0e3)


def _hog5(pkg, **kw):
    b = pkg.models.hog1p_5d()
    s = pkg.FspSolverMultiSinks(backend="box", **kw)
    s.set_model(b.model)
    s.set_constraint_functions(b.constraint)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors(b.expansion_factors)
    s.set_initial_distribution(b.x0, b.p0)
    return s.set_up()


def test_preallocate_takes_the_reference_growable_axes():
    """hog1p_5d with ``preallocate=True``: the gene axis (capped by a
    bound that never grows) is not water-filled, the other four are, in
    the permuted layout; axis order and capacity are the reference's.
    ``"auto"`` and False keep the ladder."""
    ts = _hog5(pt, device="cpu", preallocate=True)
    js = _hog5(pm, preallocate=True, pallas=False)
    assert ts.axis_orders_ == [(None, [1, 4, 0, 3, 2])]
    np.testing.assert_array_equal(ts._space.growable_axes,
                                  js._space.growable_axes)
    assert ts._space.growable_axes.tolist() == [True, True, False, True,
                                                True]
    assert tuple(ts._space.shape) == tuple(js._space.shape)
    assert ts._space.prealloc_budget == pytest.approx(
        ts._box_elem_budget())
    for pre in ("auto", False):
        s = _hog5(pt, device="cpu", preallocate=pre)
        assert s._space.prealloc_budget is None
    with pytest.raises(pt.SetupError):
        pt.FspSolverMultiSinks(device="cpu", preallocate="yes")


def test_prealloc_solve_matches_default():
    """``tests/test_prealloc.py:85-103`` on the port at a CPU size: the
    repressilator to t = 0.2 on an eagerly allocated box has the ladder
    solve's states, total variation <= 1e-6."""
    def run(pre):
        b = pt.models.repressilator()
        s = pt.FspSolverMultiSinks(backend="box", odes_type="krylov",
                                   device="cpu", preallocate=pre)
        s.set_model(b.model)
        s.set_constraint_functions(b.constraint)
        s.set_initial_bounds(b.bounds)
        s.set_expansion_factors(b.expansion_factors)
        s.set_initial_distribution(b.x0, b.p0)
        return s, s.solve(0.2, 1e-4)
    (s1, d1), (s2, d2) = run(True), run(False)
    assert s1._space.prealloc_budget is not None
    assert s1._space.size > s2._space.size
    assert d1.num_states == d2.num_states
    m = {tuple(x): float(p) for x, p in zip(d2.states, d2.p)}
    assert 0.5 * sum(abs(float(p) - m[tuple(x)])
                     for x, p in zip(d1.states, d1.p)) <= 1e-6


def test_prealloc_budget_is_shared_by_the_rows():
    """A sensitivity solve stacks p and each s_j: eager capacity gives
    each row its share of the element budget, and the migration check
    holds the grown box to that same share."""
    hs = pt.models.hog1p_5d_sens()
    s = pt.SensFspSolverMultiSinks(backend="box", device="cpu",
                                   preallocate=True)
    s.set_model(hs.model)
    s.set_constraint_functions(hs.constraint)
    s.set_initial_bounds(hs.bounds)
    s.set_expansion_factors(hs.expansion_factors)
    s.set_initial_distribution(hs.x0, hs.p0)
    s.set_up()
    share = s._box_elem_budget() / 3
    assert s._space.prealloc_budget == pytest.approx(share)
    assert s._capacity_budget() == pytest.approx(share)
    assert s._space.size <= share
