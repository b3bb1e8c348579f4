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
