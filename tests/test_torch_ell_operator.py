"""The port's compressed (ELL) operator against the reference package's
(``PACMENSL_ELL_GATHER=plain``, the reference's own switch to its plain
gather): ``dp`` and sinks within 1e-13 absolute on probability vectors
(hog1p_3d at t = 0 and t = 30, time-varying; the repressilator at its
initial bounds), a reaction subset (``enable_reactions``), and
``dense_matrix``.  Beside the 1e-13, 1e-15 relative: hog1p_3d's sinks at
t = 30 reach 956, where one unit in the last place is 1.1e-13.  Also the port's ELL action against its own dense
matrix and against its box action on the same valid states
(``tests/test_operators.py:75, 96``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.ops.ell_operator import EllOperator as JEll  # noqa: E402
from pacmensl_tpu.ops.vecops import FspVector as JVec  # noqa: E402
from pacmensl_tpu.statespace.constraints import (  # noqa: E402
    ConstraintSet as JCS)
from pacmensl_tpu.statespace.state_set import (  # noqa: E402
    StateSet as JStateSet)
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.ops.vecops import FspVector  # noqa: E402
from pacmensl_tpu_torch.statespace.constraints import (  # noqa: E402
    ConstraintSet)

CASES = {"hog1p_3d": [3, 8, 8, 3, 20, 20, 20], "repressilator": None}


def _pair(name, bounds, reactions=None):
    jb, tb = getattr(pm.models, name)(), getattr(pt.models, name)()
    bounds = tb.bounds if bounds is None else bounds
    js = JStateSet(jb.model.stoichiometry, JCS(jb.constraint, bounds),
                   init_states=jb.x0)
    ts = pt.StateSet(tb.model.stoichiometry,
                     ConstraintSet(tb.constraint, bounds), init_states=tb.x0)
    js.expand()
    ts.expand()
    np.testing.assert_array_equal(ts.states, js.states)
    return (JEll(jb.model, js, enable_reactions=reactions),
            pt.EllOperator(tb.model, ts, device="cpu",
                           enable_reactions=reactions))


def _prob(n, n_pad, seed):
    p = np.zeros(n_pad)
    p[:n] = np.random.default_rng(seed).random(n)
    return p / p.sum()


def _compare(jop, top, t, seed, rtol=1e-15):
    n = top.n_states
    assert top.n_pad == jop.n_pad and top.nnz() == jop.nnz()
    p = _prob(n, top.n_pad, seed)
    jd = jop.action(t, JVec(p=jnp.asarray(p),
                            sinks=jnp.zeros(jop.num_constraints)))
    td = top.action(t, FspVector(p=torch.as_tensor(p),
                                 sinks=torch.zeros(top.num_constraints)))
    np.testing.assert_allclose(td.p.numpy(), np.asarray(jd.p), rtol=rtol,
                               atol=1e-13)
    np.testing.assert_allclose(td.sinks.numpy(), np.asarray(jd.sinks),
                               rtol=rtol, atol=1e-13)
    assert not td.p[n:].any()


@pytest.mark.parametrize("name,times", [("hog1p_3d", (0.0, 30.0)),
                                        ("repressilator", (0.0,))])
def test_action_matches_reference(monkeypatch, name, times):
    monkeypatch.setenv("PACMENSL_ELL_GATHER", "plain")
    jop, top = _pair(name, CASES[name])
    for k, t in enumerate(times):
        _compare(jop, top, t, seed=k)
    np.testing.assert_allclose(top.dense_matrix(times[-1]),
                               jop.dense_matrix(times[-1]), rtol=0,
                               atol=1e-13)


def test_reaction_subset_matches_reference(monkeypatch):
    """Reactions 0, 2 and 5 of hog1p_3d at t = 30."""
    monkeypatch.setenv("PACMENSL_ELL_GATHER", "plain")
    jop, top = _pair("hog1p_3d", CASES["hog1p_3d"], reactions=(0, 2, 5))
    _compare(jop, top, 30.0, seed=3)
    np.testing.assert_allclose(top.diagonal(30.0).numpy(),
                               np.asarray(jop.diagonal(30.0)), rtol=0,
                               atol=1e-13)


def test_action_matches_dense():
    b = pt.models.toggle()
    ss = pt.StateSet(b.model.stoichiometry,
                     ConstraintSet(b.constraint, [6, 6, 12]),
                     init_states=b.x0)
    ss.expand()
    op = pt.EllOperator(b.model, ss, device="cpu")
    A, n = op.dense_matrix(), ss.num_states
    for seed in range(3):
        p = _prob(n, op.n_pad, seed)
        d = op.action(0.0, FspVector(p=torch.as_tensor(p),
                                     sinks=torch.zeros(op.num_constraints)))
        ref = A @ p[:n]
        np.testing.assert_allclose(d.p.numpy()[:n], ref[:n], rtol=1e-12,
                                   atol=1e-15)
        np.testing.assert_allclose(d.sinks.numpy(), ref[n:], rtol=1e-12,
                                   atol=1e-15)


def test_box_matches_ell():
    b = pt.models.toggle()
    cs = ConstraintSet(b.constraint, [6, 6, 12])
    space = pt.BoxStateSpace(b.model.stoichiometry, cs, b.x0, device="cpu")
    bop = pt.BoxOperator(b.model, space)
    ss = pt.StateSet(b.model.stoichiometry, cs, init_states=b.x0)
    ss.expand()
    eop = pt.EllOperator(b.model, ss, device="cpu")
    n = ss.num_states
    assert space.num_states == n
    pe = _prob(n, eop.n_pad, 7)
    idx = space.state2index(ss.states)
    assert (idx >= 0).all()
    pb = np.zeros(space.size)
    pb[idx] = pe[:n]
    nc = cs.num_constraints
    de = eop.action(0.0, FspVector(p=torch.as_tensor(pe),
                                   sinks=torch.zeros(nc)))
    db = bop.action(0.0, FspVector(p=torch.as_tensor(pb),
                                   sinks=torch.zeros(nc)))
    np.testing.assert_allclose(db.p.numpy()[idx], de.p.numpy()[:n], rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(db.sinks.numpy(), de.sinks.numpy(), rtol=0,
                               atol=1e-13)


def test_reassemble_grows_capacity_on_the_ladder():
    b = pt.models.poisson(2.0)
    ss = pt.StateSet(b.model.stoichiometry, ConstraintSet(None, [100]),
                     init_states=b.x0)
    ss.expand()
    op = pt.EllOperator(b.model, ss, device="cpu")
    assert (op.n_states, op.n_pad) == (101, 128)
    ss.set_bounds([120])
    ss.expand(old_bounds=[100])
    assert not op.reassemble() and op.n_pad == 128
    ss.set_bounds([200])
    ss.expand(old_bounds=[120])
    assert op.reassemble() and op.n_pad == 256
    # the sink data is compact: one boundary transition, one constraint
    assert tuple(op.sink_w.shape) == (1, 1)
