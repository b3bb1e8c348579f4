"""The port's box operator against the reference package's fused Pallas
kernel (``BoxOperator(use_pallas=True)``, interpret mode on the CPU).

On the CPU the port's ``BoxOperator.action`` runs the kernel's plain
version (``box_action_reference``); both sides compute in float64 and are
held to rtol 1e-12 / atol 1e-13, the reference package's own tolerance
for its kernel against its XLA path (tests/test_pallas.py)."""
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

TOL = dict(rtol=1e-12, atol=1e-13)


def _pair(name, bounds):
    jb = pm.models.ALL_MODELS[name]()
    tb = pt.models.ALL_MODELS[name]()
    jcs = pm.ConstraintSet(jb.constraint, bounds, jb.expansion_factors)
    tcs = pt.ConstraintSet(tb.constraint, bounds, tb.expansion_factors)
    js = JBox(jb.model.stoichiometry, jcs, jb.x0)
    ts = pt.BoxStateSpace(tb.model.stoichiometry, tcs, tb.x0, device="cpu")
    jop = JOp(jb.model, js, dtype=jnp.float64, use_pallas=True)
    assert jop._pallas is not None
    return jop, pt.BoxOperator(tb.model, ts), js


def _compare(jop, top, js, t, seed):
    rng = np.random.default_rng(seed)
    mask = js.mask_host
    p = np.where(mask, rng.random(js.shape), 0.0)
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
    ("poisson", [50], [0.0]),
    ("toggle", [12, 9, 40], [0.0]),
    ("repressilator", [22, 2, 2, 44, 4, 44], [0.0]),
    ("hog1p_3d", [3, 4, 4, 1, 10, 10, 10], [0.0, 30.0, 120.0]),
])
def test_action_matches_reference_kernel(name, bounds, times):
    jop, top, js = _pair(name, np.asarray(bounds))
    for i, t in enumerate(times):
        _compare(jop, top, js, t, seed=i)


def test_action_after_bounds_change_in_capacity():
    """An epoch's bounds change at fixed capacity reaches the operator as
    data (mask and violation bits), as in the reference package."""
    jop, top, js = _pair("toggle", np.array([16, 9, 40]))
    shape0 = tuple(js.shape)
    new = np.array([18, 9, 41])
    js.set_bounds(new)
    top.space.set_bounds(new)
    assert tuple(js.shape) == shape0 == tuple(top.space.shape)
    jop.refresh_data()
    top.refresh_data()
    _compare(jop, top, js, 0.0, seed=3)


def test_operator_bookkeeping_matches_reference():
    jop, top, js = _pair("repressilator", np.array([22, 2, 2, 44, 4, 44]))
    assert top.local_mv_flops() == jop.local_mv_flops()
    assert top.nnz() == jop.nnz()
    np.testing.assert_allclose(top.diagonal(0.0).numpy(),
                               np.asarray(jop.diagonal(0.0)).reshape(-1),
                               **TOL)

