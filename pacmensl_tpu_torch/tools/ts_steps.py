"""Steps of a PETSc TS method on the repressilator: how deep a run of it
can go.

    python -m pacmensl_tpu_torch.tools.ts_steps [--ts rk|cn|bdf]
        [--t T [T ...]] [--backend box|ell|auto] [--device cuda|cpu]

For each end time T, one solve of the repressilator (its bundle's custom
constraints, fsp_tol 1e-4) under ``-fsp_odes_type petsc -ts_type <ts>``
from t = 0, and one line on stdout: the state count, accepted steps,
rejected steps, RHS evaluations, epochs and the wall (host clock around
``solve``, ended by a device synchronisation on a card).  Without
``--device`` it runs on the card and raises ``SetupError`` where there is
none.
"""
from __future__ import annotations

import argparse
import time

import torch

import pacmensl_tpu_torch as pt


def solve(ts: str, t_final: float, backend: str, device: str) -> str:
    rep = pt.models.repressilator()
    s = pt.FspSolverMultiSinks(backend=backend, device=device)
    s.set_from_options(pt.Options.from_argv(
        ["-fsp_odes_type", "petsc", "-ts_type", ts]))
    s.set_model(rep.model)
    s.set_constraint_functions(rep.constraint)
    s.set_initial_bounds(rep.bounds)
    s.set_expansion_factors(rep.expansion_factors)
    s.set_initial_distribution(rep.x0, rep.p0)
    t0 = time.perf_counter()
    d = s.solve(t_final, 1.0e-4)
    if s.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev = s.get_event_log().events
    return (f"{ts} t={t_final:g} on {s._backend_used} ({s.device}): "
            f"{d.num_states} states, steps {ev['ODESteps'].count}, rejected "
            f"{ev['ODEStepsRejected'].count}, RHS evaluations "
            f"{ev['RHSEvaluation'].count}, epochs {ev['ODESolve'].count}, "
            f"wall {wall:.2f} s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ts", default="cn")
    ap.add_argument("--t", type=float, nargs="+", default=[0.02])
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    for t in args.t:
        print(solve(args.ts, t, args.backend, args.device), flush=True)


if __name__ == "__main__":
    main()
