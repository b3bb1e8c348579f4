"""The port's compressed state set and partitioner against the reference
package's (``tests/test_statespace.py``, ``tests/test_native.py``,
``tests/test_partitioner_wiring.py``): the same states in the same
insertion order, -1 for absent states, reorder keeping the set and its
lookup, and the BLOCK and GRAPH orderings equal.  HYPERGRAPH (a Fiedler
order from ARPACK, whose start vector is random) is held to the
reference's by its connectivity cut.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.statespace.constraints import (  # noqa: E402
    ConstraintSet as JConstraintSet)
from pacmensl_tpu.statespace.state_set import (  # noqa: E402
    StateSet as JStateSet)
from pacmensl_tpu.statespace.partitioner import (  # noqa: E402
    StatePartitioner as JPartitioner, PartitioningType as JType)
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.statespace.constraints import (  # noqa: E402
    ConstraintSet)
from pacmensl_tpu_torch.statespace.state_set import StateSet  # noqa: E402
from pacmensl_tpu_torch.statespace.partitioner import (  # noqa: E402
    StatePartitioner, PartitioningType)

TOGGLE_SM = np.array([[1, 0], [1, 0], [-1, 0], [0, 1], [0, 1], [0, -1]])


def _simplex_j(x):
    return jnp.stack([x[:, 0], x[:, 1], x[:, 0] + x[:, 1]], axis=1)


def _simplex_t(x):
    return torch.stack([x[:, 0], x[:, 1], x[:, 0] + x[:, 1]], dim=1)


def _pair(bounds, use_native=True):
    j = JStateSet(TOGGLE_SM, JConstraintSet(_simplex_j, bounds),
                  init_states=[[0, 0]])
    t = StateSet(TOGGLE_SM, ConstraintSet(_simplex_t, bounds),
                 init_states=[[0, 0]], use_native=use_native)
    return j, t


@pytest.mark.parametrize("use_native", [True, False])
def test_toggle_simplex_enumeration(use_native):
    j, t = _pair([3, 3, 3], use_native)
    assert j.expand() == t.expand() == 9
    np.testing.assert_array_equal(t.states, j.states)
    assert (t.state2index(t.states) == np.arange(10)).all()
    assert (t.state2index([[4, 0], [2, 2], [-1, 0]]) == -1).all()


@pytest.mark.parametrize("seeded", [False, True])
def test_expand_after_bounds_growth(seeded):
    """Growth with and without the boundary seed (``old_bounds``)."""
    j, t = _pair([3, 3, 3])
    j.expand()
    t.expand()
    for ss in (j, t):
        ss.set_bounds([4, 4, 6])
        ss.expand(old_bounds=[3, 3, 3] if seeded else None)
    assert t.num_states == 22   # x0, x1 <= 4 and x0 + x1 <= 6
    np.testing.assert_array_equal(t.states, j.states)
    np.testing.assert_array_equal(t.state2index(j.states), np.arange(22))


def test_key_space_grows_for_gated_constraints():
    """hog1p_3d's gated constraints defeat the bounding-box probe; the
    key space must grow so no reachable state is dropped."""
    jb, tb = pm.models.hog1p_3d(), pt.models.hog1p_3d()
    j = JStateSet(jb.model.stoichiometry,
                  JConstraintSet(jb.constraint, jb.bounds),
                  init_states=jb.x0)
    t = StateSet(tb.model.stoichiometry,
                 ConstraintSet(tb.constraint, tb.bounds), init_states=tb.x0)
    j.expand()
    t.expand()
    np.testing.assert_array_equal(t.states, j.states)
    assert (t.state2index(t.states) == np.arange(t.num_states)).all()


def _expanded_toggle(pkg, Set, CS):
    b = pkg.models.toggle()
    ss = Set(b.model.stoichiometry, CS(None, [15, 15]), init_states=b.x0)
    ss.expand()
    ss.set_bounds([31, 31])
    ss.expand()
    return b, ss


def test_reorder_preserves_set_and_lookup():
    _, ss = _expanded_toggle(pt, StateSet, ConstraintSet)
    before = {tuple(s) for s in ss.states}
    ss.reorder(np.random.default_rng(0).permutation(ss.num_states))
    assert {tuple(s) for s in ss.states} == before
    np.testing.assert_array_equal(ss.state2index(ss.states),
                                  np.arange(ss.num_states))


@pytest.mark.parametrize("ptype", ["block", "graph"])
def test_orderings_match_the_reference(ptype):
    jb, jss = _expanded_toggle(pm, JStateSet, JConstraintSet)
    _, tss = _expanded_toggle(pt, StateSet, ConstraintSet)
    np.testing.assert_array_equal(tss.states, jss.states)
    jr = JPartitioner(JType.from_string(ptype)).partition(
        jss.states, jb.model.stoichiometry, 4, state2index=jss.state2index)
    tr = StatePartitioner(PartitioningType.from_string(ptype)).partition(
        tss.states, jb.model.stoichiometry, 4, state2index=tss.state2index)
    np.testing.assert_array_equal(tr.order, jr.order)
    np.testing.assert_array_equal(tr.boundaries, jr.boundaries)


def test_hypergraph_cut_matches_the_reference():
    jb, jss = _expanded_toggle(pm, JStateSet, JConstraintSet)
    _, tss = _expanded_toggle(pt, StateSet, ConstraintSet)
    sm = jb.model.stoichiometry
    jr = JPartitioner(JType.HYPERGRAPH).partition(
        jss.states, sm, 8, state2index=jss.state2index)
    tr = StatePartitioner(PartitioningType.HYPERGRAPH).partition(
        tss.states, sm, 8, state2index=tss.state2index)
    assert sorted(tr.order.tolist()) == list(range(tss.num_states))
    jc = JPartitioner.partition_cuts(jss.states, sm, jss.state2index,
                                     jr.order, jr.boundaries)
    tc = StatePartitioner.partition_cuts(tss.states, sm, tss.state2index,
                                         tr.order, tr.boundaries)
    assert tc["connectivity_cut"] <= 1.1 * jc["connectivity_cut"]


def test_hierarchical_raises():
    with pytest.raises(ValueError):
        StatePartitioner(PartitioningType.HIERARCHICAL)
    with pytest.raises(pt.SetupError):
        pt.FspSolverMultiSinks(device="cpu").set_load_balancing_method(
            "hierarchical")
