"""Each configuration's network is the published model: its
propensities, time coefficients, constraints and initial data equal the
program's library bundle over a small box."""
import itertools

import numpy as np
import pytest
import torch

import pacmensl_tpu_torch as pt
from fspbench.lib import config

BUNDLES = {"hog1p_5d": pt.models.hog1p_5d,
           "repressilator_box": pt.models.repressilator}


def box(shape):
    return torch.tensor(list(itertools.product(*[range(n) for n in shape])),
                        dtype=torch.int64)


@pytest.mark.parametrize("name", sorted(BUNDLES))
def test_network_is_the_library_model(name):
    cfg, b = config.load(name), BUNDLES[name]()
    x = box([4] + [7] * (cfg.num_species - 1))
    xf = x.to(torch.float64)
    assert np.array_equal(cfg.stoich, b.model.stoichiometry)
    ones = np.ones(cfg.num_reactions)
    for r in range(cfg.num_reactions):
        got = cfg.propensity(xf, r, ones)
        want = torch.as_tensor(b.model.propensity(x, r)).to(torch.float64)
        assert torch.equal(got, want.expand_as(got)), r
    for t in (0.0, 1.0, 10.0, 25.0, 27.0, 90.0, 180.0):
        assert torch.equal(cfg.t_coeff(t), b.model.coefficients(t))
    assert torch.equal(config.constraint_values(cfg.forms, x),
                       b.constraint(x).to(torch.int64))
    assert np.array_equal(cfg.bounds, b.bounds)
    assert np.array_equal(cfg.expansion_factors, b.expansion_factors)
    assert np.array_equal(cfg.x0, b.x0) and np.array_equal(cfg.p0, b.p0)
    assert cfg.tv_reactions == tuple(b.model.tv_reactions)
