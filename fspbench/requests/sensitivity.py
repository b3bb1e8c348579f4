"""Request kind ``sensitivity``: one certified forward-sensitivity solve,
``p`` and ``dp / d theta_j`` for the configuration's ``parameters``.

The program serves it as a fit by gradient or an experiment design calls
it: a new ``SensFspSolverMultiSinks`` per request with the default
options, built through the public API as :func:`fspbench.lib.port.
new_solver` builds the transient one (a ``SensModel`` whose derivative
propensities are the network's ``d_propensity`` times the request's rate
factors, the constraint functions, the initial bounds, the expansion
factors, the initial distribution with ``dp0``), then ``solve(t_final,
fsp_tol)``.  The answer is the distribution's states, ``p``, ``dp [Np,
n]`` and sinks, and the sinks of each ``s_j``, read from the solver's
stacked solution after the solve (the distribution carries ``p``'s only).

The plain reference (:mod:`fspbench.lib.sens_reference`) solves the same
request.  The comparison: ``l1``, ``excess`` and ``balance`` on ``p``
(:mod:`fspbench.lib.check`), and ``sens_l1``, the largest over the
parameters of sum |s_j - s_ref,j| / sum |s_ref,j| over both state sets
and the sinks."""
from __future__ import annotations

import numpy as np
import torch

import pacmensl_tpu_torch as pt
from fspbench.lib import check, port, sens_reference


def sens_model(cfg, factors) -> "pt.SensModel":
    """The network with every propensity, and every derivative
    propensity, times its reaction's rate factor."""
    f = [float(v) for v in factors]
    pars = sens_reference.parameters(cfg)
    base = port.model(cfg, f)

    def d_prop(x, j, r):
        xf = x if x.is_floating_point() else x.to(torch.float64)
        return f[r] * cfg.net.d_propensity(xf, j, r, cfg.rates)

    return pt.SensModel(
        base.stoichiometry, base.propensity, base.t_coeff,
        tv_reactions=base.tv_reactions, num_parameters=len(pars),
        d_propensity=d_prop,
        dprop_sparsity=tuple(tuple(p["reactions"]) for p in pars))


def new_solver(cfg, factors, device="cuda"):
    """A sensitivity solver set up for one request, as a fit sets one
    up."""
    s = pt.SensFspSolverMultiSinks(device=device)
    s.set_from_options(pt.Options.from_argv(list(cfg.data["solver_options"])))
    s.set_model(sens_model(cfg, factors))
    s.set_constraint_functions(port.constraint_fn(cfg))
    s.set_initial_bounds(cfg.bounds)
    s.set_expansion_factors(cfg.expansion_factors)
    s.set_initial_distribution(cfg.x0, cfg.p0,
                               np.asarray(cfg.data["dp0"], np.float64))
    return s


def warm_up(cfg, mix, device) -> None:
    """One short sensitivity solve of the configuration per entry of its
    ``warmup``."""
    for w in cfg.data["warmup"]:
        s = new_solver(cfg, np.ones(cfg.num_reactions), device)
        s.solve(float(w["t_final"]), cfg.fsp_tol)


def serve(cfg, mix, factors, device):
    """``(solver, answer)``: the program's solve of one request, its
    answer as host arrays."""
    s = new_solver(cfg, factors, device)
    d = s.solve(cfg.t_final, cfg.fsp_tol)
    rows = 1 + d.num_parameters
    dsinks = s._y.sinks.reshape(rows, -1)[1:].cpu().numpy()
    return s, {"states": np.asarray(d.states), "p": np.asarray(d.p),
               "dp": np.asarray(d.dp), "sinks": np.asarray(d.sinks),
               "dsinks": dsinks}


def reference_solve(cfg, mix, factors, device, dtype=torch.float64,
                    t_final=None):
    return sens_reference.solve(cfg, factors, device, dtype,
                                t_final=t_final)


def as_answer(ref) -> dict:
    """The reference's solve in the form of the program's answer (the
    control puts it in the program's place)."""
    return {"states": ref.box.states.cpu().numpy(),
            "p": ref.p.to(torch.float64).cpu().numpy(),
            "dp": ref.s.to(torch.float64).cpu().numpy(),
            "sinks": np.asarray(ref.sinks),
            "dsinks": np.asarray(ref.dsinks)}


def sens_errors(answer, ref) -> list:
    """Per parameter, sum |s_j - s_ref,j| / sum |s_ref,j| over both state
    sets (a state outside one set counts the other's value whole) and the
    sinks."""
    idx = ref.box.index(torch.as_tensor(np.ascontiguousarray(
        answer["states"])))
    on = idx >= 0
    out = []
    for j in range(ref.s.shape[0]):
        sr = ref.s[j].to(torch.float64)
        at = torch.where(on, sr[idx.clamp(min=0)], 0.0)
        got = torch.as_tensor(np.asarray(answer["dp"][j], np.float64),
                              device=sr.device)
        rest = float(sr.abs().sum()) - float(at.abs().sum())
        ds = np.asarray(answer["dsinks"][j], np.float64) - ref.dsinks[j]
        num = float((got - at).abs().sum()) + rest + float(np.abs(ds).sum())
        den = float(sr.abs().sum()) + float(np.abs(ref.dsinks[j]).sum())
        out.append(num / den)
    return out


def compare(answer, ref) -> dict:
    got = check.compare(answer["states"], answer["p"], answer["sinks"],
                        ref)
    per = sens_errors(answer, ref)
    got["sens_l1"] = max(per)
    got["sens_l1_each"] = per
    return got


def limits(cfg) -> dict:
    return check.limits(cfg)


def describe(ref, got) -> str:
    return (f"{ref.box.n} states, lost {ref.lost!r}, {ref.steps} steps "
            f"({ref.redone} redone), {ref.terms} terms; program "
            f"{got['prog_mass']!r} mass, 1 - mass - sinks "
            f"{got['signed_balance']!r}, {got['outside_ref']} states "
            f"outside the reference's set; sens_l1 per parameter "
            f"{got['sens_l1_each']!r}")
