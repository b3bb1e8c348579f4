"""Mixed-radix index math of the PyTorch port against the reference
package (the cases of tests/test_indexing.py, on seeded inputs)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pacmensl_tpu.sys import indexing as jidx  # noqa: E402
from pacmensl_tpu_torch.sys import indexing as tidx  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_indexing_matches_reference(seed):
    rng = np.random.default_rng(seed)
    S = 2 + seed
    nmax = rng.integers(1, 9, size=S)
    states = rng.integers(-2, 11, size=(300, S))
    np.testing.assert_array_equal(tidx.sub2ind(nmax, states),
                                  jidx.sub2ind(nmax, states))
    inside = states[((states >= 0) & (states <= nmax)).all(axis=1)]
    keys = tidx.sub2ind(nmax, inside)
    np.testing.assert_array_equal(tidx.ind2sub(nmax, keys), inside)
    np.testing.assert_array_equal(tidx.ind2sub(nmax, keys),
                                  jidx.ind2sub(nmax, keys))
    np.testing.assert_array_equal(
        tidx.sub2ind_torch(nmax, torch.as_tensor(states)).numpy(),
        np.asarray(jidx.sub2ind_jax(nmax, jnp.asarray(states))))
    dup = np.vstack([inside, inside[::3]])
    for a, b in zip(tidx.unique_states(dup), jidx.unique_states(dup)):
        np.testing.assert_array_equal(a, b)
    for n_tasks, n_workers in ((10, 3), (7, 7), (3, 5)):
        np.testing.assert_array_equal(
            tidx.distribute_tasks(n_tasks, n_workers),
            jidx.distribute_tasks(n_tasks, n_workers))
        for r in range(n_workers):
            assert tidx.get_task_range(n_tasks, n_workers, r) == \
                jidx.get_task_range(n_tasks, n_workers, r)


def test_reference_cases():
    """The cases of tests/test_indexing.py, each on both packages."""
    for idx in (tidx, jidx):
        nmax = np.array([3, 4, 5])
        rng = np.random.default_rng(0)
        states = np.stack([rng.integers(0, m + 1, size=50) for m in nmax],
                          axis=1)
        keys = idx.sub2ind(nmax, states)
        assert (keys >= 0).all()
        np.testing.assert_array_equal(idx.ind2sub(nmax, keys), states)
        # the first axis varies fastest
        assert idx.sub2ind(np.array([2, 2]), [[1, 0]])[0] == 1
        assert idx.sub2ind(np.array([2, 2]), [[0, 1]])[0] == 3
        # -1 for a negative coordinate, -(i + 2) for coordinate i over
        # its maximum (reference pacmenMath.h:41-55)
        keys = idx.sub2ind(np.array([3, 4]),
                           [[-1, 0], [4, 0], [0, 5], [3, 4]])
        assert keys.tolist() == [-1, -2, -3, 3 + 4 * 4]
        st = np.array([[0, 0], [1, 0], [0, 0], [2, 1], [1, 0]])
        uniq, inv = idx.unique_states(st)
        assert uniq.shape == (3, 2)
        np.testing.assert_array_equal(uniq[inv], st)
        counts = idx.distribute_tasks(10, 3)
        assert counts.sum() == 10 and counts.tolist() == [4, 3, 3]
        assert idx.get_task_range(10, 3, 1) == (4, 7)
    nmax = np.array([5, 6, 7])
    rng = np.random.default_rng(1)
    states = np.stack([rng.integers(0, m + 1, size=30) for m in nmax],
                      axis=1)
    np.testing.assert_array_equal(
        tidx.sub2ind_torch(nmax, torch.as_tensor(states)).numpy(),
        tidx.sub2ind(nmax, states))
