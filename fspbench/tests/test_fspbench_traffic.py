"""The mix ``fit``: the same requests for the same seed; every seed sends
the same cycle (the published point, then each reaction's rate stepped by
1%) from another start."""
import itertools

import numpy as np

from fspbench.lib import traffic


def take(seed, R, n):
    return list(itertools.islice(
        traffic.requests(seed, R), n))


def test_same_seed_same_requests():
    for seed in (0, 7, 2**31 + 12345, 3 * 2**32):
        a, b = take(seed, 9, 25), take(seed, 9, 25)
        assert all(i == j and np.array_equal(x, y)
                   for (i, x), (j, y) in zip(a, b))


def test_every_seed_sends_one_cycle_in_another_order():
    R = 6
    cycle = [np.ones(R)] + [np.where(np.arange(R) == j, 1.01, 1.0)
                            for j in range(R)]
    starts = set()
    for seed in range(2**31, 2**31 + 12):
        reqs = take(seed, R, 2 * (R + 1))
        k = reqs[0][0]
        starts.add(k)
        for i, (j, r) in enumerate(reqs):
            assert j == (k + i) % (R + 1)
            assert np.array_equal(r, cycle[j])
    assert len(starts) > 1
