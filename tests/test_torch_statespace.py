"""Dense-box state space of the PyTorch port against the reference
package's ``BoxStateSpace``: capacity, validity mask, state count,
``state2index`` and ``embed_old``, at the first build and after bound
growth within and beyond the capacity."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.statespace.box_space import BoxStateSpace as JBox  # noqa: E402
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.ops.stencil import shift_nd  # noqa: E402

# (model, initial bounds, bounds within capacity, bounds beyond capacity)
CASES = {
    "toggle": (np.array([12, 9, 40]), np.array([12, 11, 44]),
               np.array([30, 25, 300])),
    "repressilator": (np.array([22, 2, 2, 44, 4, 44]),
                      np.array([24, 3, 2, 46, 5, 46]),
                      np.array([40, 10, 8, 200, 40, 150])),
    "hog1p_3d": (np.array([3, 4, 4, 1, 10, 10, 10]),
                 np.array([3, 5, 5, 2, 11, 11, 11]),
                 np.array([3, 12, 12, 6, 20, 20, 20])),
}


def _pair(name, bounds):
    jb = pm.models.ALL_MODELS[name]()
    tb = pt.models.ALL_MODELS[name]()
    jcs = pm.ConstraintSet(jb.constraint, bounds, jb.expansion_factors)
    tcs = pt.ConstraintSet(tb.constraint, bounds, tb.expansion_factors)
    return (JBox(jb.model.stoichiometry, jcs, jb.x0),
            pt.BoxStateSpace(tb.model.stoichiometry, tcs, tb.x0,
                             device="cpu"))


def _assert_same(js, ts, rng):
    assert tuple(ts.shape) == tuple(js.shape)
    assert ts.num_states == js.num_states
    np.testing.assert_array_equal(ts.mask_host, js.mask_host)
    np.testing.assert_array_equal(ts.states(), js.states())
    S = len(js.shape)
    probe = np.vstack([js.states()[:50],
                       rng.integers(-2, max(js.shape) + 2, size=(200, S))])
    np.testing.assert_array_equal(ts.state2index(probe),
                                  js.state2index(probe))


@pytest.mark.parametrize("name", sorted(CASES))
def test_box_space_matches_reference(name):
    b0, b_in, b_out = CASES[name]
    rng = np.random.default_rng(7)
    js, ts = _pair(name, b0)
    _assert_same(js, ts, rng)

    # growth within capacity: same shape, larger mask, identity embedding
    shape0 = tuple(js.shape)
    js.set_bounds(b_in)
    ts.set_bounds(b_in)
    assert tuple(ts.shape) == shape0
    _assert_same(js, ts, rng)
    p = rng.random(shape0)
    np.testing.assert_array_equal(
        ts.embed_old(torch.as_tensor(p.reshape(-1)), shape0).numpy(),
        p.reshape(-1))

    # growth beyond capacity: zero-pad embedding into the larger box
    js.set_bounds(b_out)
    ts.set_bounds(b_out)
    assert tuple(ts.shape) != shape0
    _assert_same(js, ts, rng)
    want = np.asarray(js.embed_old(jnp.asarray(p), shape0)).reshape(-1)
    got = ts.embed_old(torch.as_tensor(p.reshape(-1)), shape0).numpy()
    np.testing.assert_array_equal(got, want)
    vals = rng.random(ts.size)
    np.testing.assert_array_equal(
        ts.extract_valid(torch.as_tensor(vals)),
        js.extract_valid(jnp.asarray(vals.reshape(js.shape))))


def test_shift_nd_zero_fill():
    a = torch.arange(24, dtype=torch.float64).reshape(2, 3, 4)
    for s in [(0, 1, 0), (1, -1, 2), (0, 0, -3), (3, 0, 0), (-1, 2, -1)]:
        want = np.zeros((2, 3, 4))
        src = a.numpy()
        for i in np.ndindex(2, 3, 4):
            j = tuple(np.subtract(i, s))
            if all(0 <= jj < n for jj, n in zip(j, (2, 3, 4))):
                want[i] = src[j]
        np.testing.assert_array_equal(shift_nd(a, s).numpy(), want)


def test_initial_state_violating_constraints_raises():
    b = pt.models.toggle()
    cs = pt.ConstraintSet(b.constraint, [5, 5, 10], b.expansion_factors)
    with pytest.raises(pt.StateSpaceError):
        pt.BoxStateSpace(b.model.stoichiometry, cs, [[6, 0]], device="cpu")
