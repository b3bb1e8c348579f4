"""The sensitivity cell's pieces on the host: the plain sensitivity
reference against closed forms (a Poisson birth process's dp/dk, with a
constant and a time-varying rate) and against a central difference of
its own ``p``; the configuration's network, derivative propensities
included, equal to the program's library bundle ``hog1p_5d_sens``; the
program against the reference at a small size on seeded random rate
factors; the run judged not correct with reaction 6's term left out of
d/d trans, and the float32 control failing; the per-layer readers of
the program's ``SensAction`` spans and counters."""
import contextlib
import copy
import dataclasses
import itertools
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pacmensl_tpu_torch as pt
from fspbench import control
from fspbench.lib import config, reference, runner, sens_reference, traffic

CELL = "hog1p_5d_sens.sensfit"
SMALL = {"t_final": 1.0, "warmup": [{"t_final": 0.05}]}


# ------------------------------------------------------------ closed forms
def birth_config(rate, t_final, tv=False, tol=1e-9):
    def propensity(x, r, k):
        return k["rate"] * torch.ones_like(x[:, 0])

    def d_propensity(x, j, r, k):
        return torch.ones_like(x[:, 0])

    def t_coeff(t, k):
        return torch.tensor([1.0 + 0.5 * math.sin(t)], dtype=torch.float64)

    data = {"stoichiometry": [[1]], "rates": {"rate": rate},
            "tv_reactions": [0] if tv else [],
            "parameters": [{"name": "rate", "reactions": [0]}],
            "constraints": [{"weights": [[0, 1]]}], "bounds": [5],
            "expansion_factors": [0.5], "x0": [[0]], "p0": [1.0],
            "dp0": [[0.0]], "t_final": t_final, "fsp_tol": 1e-4,
            "reference": {"tol": tol}}
    net = SimpleNamespace(propensity=propensity, t_coeff=t_coeff,
                          d_propensity=d_propensity)
    return config.Config(name="birth", data=data, net=net)


def check_poisson(res, rate, mean):
    """p = Pois(mean), dp/drate = p (x - mean) / rate, and the sink's
    derivative is minus the set's."""
    x = res.box.states[:, 0].to(torch.float64)
    pmf = torch.exp(-mean + x * math.log(mean) - torch.lgamma(x + 1.0))
    ds = pmf * (x - mean) / rate
    assert float((res.p - pmf).abs().sum()) <= 1e-8
    err = float((res.s[0] - ds).abs().sum()) / float(ds.abs().sum())
    assert err <= 1e-8, err
    assert abs(float(res.s[0].sum()) + res.dsinks[0, 0]) <= 1e-10


@pytest.mark.parametrize("factor", [1.0, 1.01])
def test_poisson_birth_sensitivity(factor):
    cfg = birth_config(2.0, 10.0)
    res = sens_reference.solve(cfg, [factor], "cpu")
    assert res.redone > 0                  # the set grew from x <= 5
    # the request's factor scales the rate: the mean is f k t and the
    # derivative with respect to k is p (x - f k t) / k
    check_poisson(res, 2.0, 20.0 * factor)


def test_time_varying_birth_sensitivity():
    t = 5.0
    cfg = birth_config(2.0, t, tv=True)
    res = sens_reference.solve(cfg, [1.0], "cpu")
    check_poisson(res, 2.0, 2.0 * (t + 0.5 * (1.0 - math.cos(t))))


def test_sensitivity_is_the_central_difference_of_p():
    """s_j against (p(theta_j (1 + e)) - p(theta_j (1 - e))) / (2 e
    theta_j), the reference's own p, on hog1p_5d to t = 5 (17,424 states,
    no growth) at e = 1e-2.  The quotient reads s_trans to 6.7e-7;
    s_gamma1, 1.4e-6 in all, to 6.8e-5, the rounding of p over 2 e
    gamma1 = 2e-5."""
    cfg = config.load("hog1p_5d_sens")
    res = sens_reference.solve(cfg, np.ones(9), "cpu", t_final=5.0)
    e = 1e-2
    for j, par in enumerate(sens_reference.parameters(cfg)):
        side = []
        for sign in (1.0, -1.0):
            f = np.ones(9)
            f[par["reactions"]] += sign * e
            r = reference.solve(cfg, f, "cpu", t_final=5.0)
            assert r.redone == 0 and r.box.n == res.box.n
            side.append(r.p)
        fd = (side[0] - side[1]) / (2.0 * e * cfg.rates[par["name"]])
        err = float((res.s[j] - fd).abs().sum()) / float(fd.abs().sum())
        assert err <= {"trans": 1e-5, "gamma1": 1e-3}[par["name"]], \
            (par["name"], err)


def test_blocked_generator_is_the_whole():
    """A generator built in blocks of states, the derivative generators
    included, is bitwise the one built at once."""
    cfg = config.load("hog1p_5d_sens")
    box = reference.StateBox(cfg, cfg.bounds, "cpu")
    f = 1.0 + 0.1 * traffic.rng(5, 7).uniform(-1.0, 1.0, 9)
    for j in (None, 0, 1):
        b = box
        if j is not None:
            b = copy.copy(box)
            b.cfg = sens_reference.derivative_config(cfg, j)
        whole = reference.Generator(b, f, torch.float64)
        blocked = sens_reference.generator(b, f, torch.float64, block=5000)
        for name in ("crow", "col", "vals", "flow", "diag_at"):
            assert torch.equal(getattr(whole, name), getattr(blocked, name))
        assert blocked.n == whole.n and blocked.tv == whole.tv


# ------------------------------------------------------ the configuration
def test_network_is_the_library_model():
    cfg, b = config.load("hog1p_5d_sens"), pt.models.hog1p_5d_sens()
    m = b.model
    x = torch.tensor(list(itertools.product(range(4), *[range(7)] * 4)),
                     dtype=torch.int64)
    xf = x.to(torch.float64)
    assert np.array_equal(cfg.stoich, m.stoichiometry)
    for r in range(cfg.num_reactions):
        got = cfg.propensity(xf, r, np.ones(9))
        want = torch.as_tensor(m.propensity(x, r)).to(torch.float64)
        assert torch.equal(got, want.expand_as(got)), r
    for t in (0.0, 10.0, 27.0, 90.0, 180.0):
        assert torch.equal(cfg.t_coeff(t), m.coefficients(t))
    pars = sens_reference.parameters(cfg)
    assert len(pars) == m.num_parameters
    assert tuple(tuple(p["reactions"]) for p in pars) == m.dprop_sparsity
    assert m.d_t_coeff is None
    for j, r in itertools.product(range(len(pars)), range(9)):
        got = cfg.net.d_propensity(xf, j, r, cfg.rates)
        want = torch.as_tensor(m.d_propensity(x, j, r)).to(torch.float64)
        assert torch.equal(got, want), (j, r)
    assert torch.equal(config.constraint_values(cfg.forms, x),
                       b.constraint(x).to(torch.int64))
    assert np.array_equal(cfg.bounds, b.bounds)
    assert np.array_equal(cfg.expansion_factors, b.expansion_factors)
    assert np.array_equal(cfg.x0, b.x0) and np.array_equal(cfg.p0, b.p0)
    assert cfg.tv_reactions == tuple(m.tv_reactions)
    assert not np.any(cfg.data["dp0"])


# ------------------------------------------- the program against it
@pytest.mark.parametrize("seed", [2**40 + 1, 2**40 + 2])
def test_program_within_the_limits_on_random_factors(seed):
    cfg = config.load("hog1p_5d_sens")
    cfg.data.update(SMALL)
    kind = runner.request_kind("sensitivity")
    f = 1.0 + 0.1 * traffic.rng(seed, 7).uniform(-1.0, 1.0, 9)
    _, answer = kind.serve(cfg, None, f, "cpu")
    got = kind.compare(answer, kind.reference_solve(cfg, None, f, "cpu"))
    for name, limit in kind.limits(cfg).items():
        assert got[name] <= limit, (name, got[name])
    assert len(got["sens_l1_each"]) == 2


@contextlib.contextmanager
def reaction_6_dropped():
    """The program is handed d/d trans without reaction 6's term."""
    orig = pt.SensFspSolverMultiSinks.set_model

    def set_model(self, model):
        d = model.d_propensity

        def dropped(x, j, r):
            out = d(x, j, r)
            return torch.zeros_like(out) if (j, r) == (0, 6) else out
        return orig(self, dataclasses.replace(model, d_propensity=dropped))
    pt.SensFspSolverMultiSinks.set_model = set_model
    try:
        yield
    finally:
        pt.SensFspSolverMultiSinks.set_model = orig


@pytest.mark.parametrize("fault", [None, reaction_6_dropped])
def test_fault_makes_the_run_incorrect(fault):
    res = runner.run_cell(CELL, 2**31 + 3, 0.2, False, "cpu", 0.0,
                          log=lambda *a, **k: None, overrides=SMALL,
                          fault=fault)
    assert res["correct"] is (fault is None), res["checks"]
    c = res["checks"]
    if fault is not None:
        # p is untouched; the sensitivity fails by far
        assert all(c[k]["value"] <= c[k]["limit"]
                   for k in ("l1", "excess", "balance"))
        assert c["sens_l1"]["value"] > 10 * c["sens_l1"]["limit"]


@pytest.mark.cuda
def test_fault_on_the_card():
    """At the cell's own size on a card (marked ``cuda``; skipped without
    one; about three minutes): one solve with reaction 6's term left out
    of d/d trans, judged not correct by ``sens_l1`` alone.

        python -m pytest --noconftest -m cuda fspbench/tests/test_fspbench_sens.py
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = runner.run_cell(CELL, 2**31 + 29, 1.0, False, "cuda", 0.0,
                          fault=reaction_6_dropped)
    c = res["checks"]
    assert res["correct"] is False
    assert all(c[k]["value"] <= c[k]["limit"]
               for k in ("l1", "excess", "balance")), c
    assert c["sens_l1"]["value"] > 10 * c["sens_l1"]["limit"], c


def test_control_fails_and_the_program_passes():
    got = control.readings(CELL, 2**31 + 11, "cpu", 5.0)
    lim = got["limits"]
    assert all(got["sound"][k] <= v for k, v in lim.items()), got["sound"]
    assert any(got["control"][k] > v for k, v in lim.items()), \
        got["control"]


# ------------------------------------------------------------ the readers
def _solve(events):
    return runner.SolveRecord(seconds=1.0, events=events, n_states=10,
                              backend="box", capacity=(4, 4), peak_bytes=0)


WITH = [_solve({"SensAction": (100, 0.5), "SensDerivative": (100, 0.1),
                "SensActionStates": (100 * 3 * 1000, 0.0),
                "SensActionSinks": (100 * 3 * 7, 0.0)}),
        _solve({"SensAction": (50, 0.2), "SensDerivative": (50, 0.1),
                "SensActionStates": (50 * 3 * 2000, 0.0),
                "SensActionSinks": (50 * 3 * 7, 0.0)})]
WITHOUT = [_solve({"ODESolve": (1, 8.0), "OperatorAction": (300, 0.6)})]


def _trace(ops):
    from fspbench.lib.trace import Trace
    return Trace(window_s=2.0, busy_s=1.0, action_device_s=0.0,
                 device_ops=ops, idle_gaps=[])


def test_readers():
    ctx = runner.Context(solves=WITH, trace=_trace([
        ("void box_action_kernel<8, true, int, false, 4, false>", 1e-3),
        ("void box_action_kernel<8, true, int, false, 1, false>", 1e-3),
        ("elementwise_kernel", 5.0)]))
    assert runner.metric_reader("sens_action_us")(ctx) == pytest.approx(
        1e6 * 0.7 / 150, rel=1e-12)
    assert runner.metric_reader("derivative_share")(ctx) == pytest.approx(
        (20.0 + 50.0) / 2, rel=1e-12)
    frozen = 16.0 * 3 * (100 * 1000 + 50 * 2000) + 8.0 * 3 * 7 * 150
    assert runner.metric_reader("sens_roofline")(ctx) == pytest.approx(
        100.0 * frozen / 3.35e12 / 2e-3, rel=1e-12)


@pytest.mark.parametrize("name", ["sens_action_us", "derivative_share",
                                  "sens_roofline"])
def test_readers_without_spans(name):
    read = runner.metric_reader(name)
    assert read(runner.Context(solves=WITHOUT,
                               trace=_trace([("box_action", 1.0)]))) is None
    assert read(runner.Context()) is None


def test_readers_listed():
    listed = {m["name"]: m for m in runner.benchmark()["per_layer"]}
    for name in ("sens_action_us", "derivative_share", "sens_roofline"):
        assert listed[name]["moves"] == "solve_s"
        assert listed[name]["workloads"] == [CELL]
        assert listed[name]["layer"] == "sensitivity operator"
