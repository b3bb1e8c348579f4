"""Request kind ``transient``: one certified transient solve.

The program serves it as a fit calls it: a new ``FspSolverMultiSinks``
built through the public API (:func:`fspbench.lib.port.new_solver`),
then ``solve(t_final, fsp_tol)``.  The plain reference solves the same
request (:mod:`fspbench.lib.reference`) and :mod:`fspbench.lib.check`
compares the two distributions."""
from __future__ import annotations

import numpy as np
import torch

from fspbench.lib import check, port, reference


def warm_up(cfg, mix, device) -> None:
    """One short solve of the configuration per entry of its ``warmup``
    (``t_final``, and a ``backend`` where one entry must load another
    backend's code)."""
    for w in cfg.data["warmup"]:
        s = port.new_solver(cfg, np.ones(cfg.num_reactions), device,
                            backend=w.get("backend"))
        s.solve(float(w["t_final"]), cfg.fsp_tol)


def serve(cfg, mix, factors, device):
    """``(solver, answer)``: the program's solve of one request, its
    answer as host arrays."""
    s = port.new_solver(cfg, factors, device)
    d = s.solve(cfg.t_final, cfg.fsp_tol)
    return s, {"states": np.asarray(d.states), "p": np.asarray(d.p),
               "sinks": np.asarray(d.sinks)}


def reference_solve(cfg, mix, factors, device, dtype=torch.float64,
                    t_final=None):
    return reference.solve(cfg, factors, device, dtype, t_final=t_final)


def as_answer(ref) -> dict:
    """The reference's solve in the form of the program's answer (the
    control puts it in the program's place)."""
    return {"states": ref.box.states.cpu().numpy(),
            "p": ref.p.to(torch.float64).cpu().numpy(),
            "sinks": np.asarray(ref.sinks)}


def compare(answer, ref) -> dict:
    return check.compare(answer["states"], answer["p"], answer["sinks"],
                         ref)


def limits(cfg) -> dict:
    return check.limits(cfg)


def describe(ref, got) -> str:
    return (f"{ref.box.n} states, lost {ref.lost!r}, {ref.steps} steps "
            f"({ref.redone} redone), {ref.terms} terms; program "
            f"{got['prog_mass']!r} mass, 1 - mass - sinks "
            f"{got['signed_balance']!r}, {got['outside_ref']} states "
            "outside the reference's set")
