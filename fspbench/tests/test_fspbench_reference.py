"""The plain reference against analytic oracles: a Poisson birth process
(the oracle of the reference library's ``test_fsp_solver.cpp:224-346``)
and a birth process whose rate varies in time."""
import math
from types import SimpleNamespace

import torch

from fspbench.lib import config, reference


def birth_config(rate, t_final, tv=False, tol=1e-9):
    def propensity(x, r, k):
        return k["rate"] * torch.ones_like(x[:, 0])

    def t_coeff(t, k):
        return torch.tensor([1.0 + 0.5 * math.sin(t)], dtype=torch.float64)

    data = {"stoichiometry": [[1]], "rates": {"rate": rate},
            "tv_reactions": [0] if tv else [],
            "constraints": [{"weights": [[0, 1]]}], "bounds": [5],
            "expansion_factors": [0.5], "x0": [[0]], "p0": [1.0],
            "t_final": t_final, "fsp_tol": 1e-4,
            "reference": {"tol": tol}}
    net = SimpleNamespace(propensity=propensity, t_coeff=t_coeff)
    return config.Config(name="birth", data=data, net=net)


def poisson_l1(res, mean):
    k = res.box.states[:, 0].to(torch.float64)
    pmf = torch.exp(-mean + k * math.log(mean) - torch.lgamma(k + 1.0))
    return float((res.p.to(torch.float64) - pmf).abs().sum()
                 + (1.0 - pmf.sum()))


def test_poisson_birth_process():
    cfg = birth_config(2.0, 10.0)
    res = reference.solve(cfg, [1.0], "cpu")
    assert res.lost <= 1e-9
    assert poisson_l1(res, 20.0) <= 1e-8
    assert res.redone > 0                  # the set grew from x <= 5


def test_rate_factor_scales_the_propensity():
    cfg = birth_config(2.0, 10.0)
    res = reference.solve(cfg, [1.01], "cpu")
    assert poisson_l1(res, 20.2) <= 1e-8


def test_time_varying_birth_process():
    t = 5.0
    cfg = birth_config(2.0, t, tv=True)
    res = reference.solve(cfg, [1.0], "cpu")
    mean = 2.0 * (t + 0.5 * (1.0 - math.cos(t)))
    assert poisson_l1(res, mean) <= 1e-8


def test_lost_mass_is_the_missing_mass():
    cfg = birth_config(2.0, 10.0, tol=1e-5)
    res = reference.solve(cfg, [1.0], "cpu")
    assert 0.0 < res.lost <= 1e-5
    assert abs(1.0 - float(res.p.sum()) - res.lost) <= 1e-12


def test_poisson_weights_sum_to_one():
    for x in (0.5, 40.0, 1000.0):
        w = reference.poisson_weights(x)
        assert abs(w.sum() - 1.0) <= 1e-15


def test_sinks_take_the_mass_that_left():
    cfg = birth_config(2.0, 10.0, tol=1e-5)
    res = reference.solve(cfg, [1.0], "cpu")
    assert res.sinks.shape == (1,)
    assert abs(res.sinks[0] - res.lost) <= 1e-15
