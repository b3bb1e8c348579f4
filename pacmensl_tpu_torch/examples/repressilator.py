"""Repressilator benchmark script.

Counterpart of the JAX package's ``examples/repressilator.py`` (the
reference ``examples/repressilator.cpp``): solves the 3-species
repressilator CME to t_final = 10 with fsp_tol = 1e-4 under four
configurations (adaptive / fixed final bounds x custom / hyper-rectangle
constraints), reports each stage's wall and event log, and writes the
final marginal distributions and the per-step trace as CSV.

Usage:
    python -m pacmensl_tpu_torch.examples.repressilator [-fsp_verbosity 1]
        [-fsp_odes_type krylov|cvode|petsc] [-t_final 10] [-fsp_tol 1e-4]
        [-out_dir results] [-device cuda|cpu]
"""
import os

import pacmensl_tpu_torch as pt
from pacmensl_tpu_torch.examples import common

#: the four stages, in the reference's order
STAGES = ("adaptive_custom", "adaptive_hyperrec", "fixed_custom",
          "fixed_hyperrec")


def run_stage(name, bundle, constraint, bounds, factors, opts, t_final,
              fsp_tol, out_dir, device="cuda"):
    """One stage: a solve from the bundle's initial distribution under
    ``constraint`` (None: the default hyper-rectangle) from ``bounds``;
    writes ``repressilator_marginal_<i>_<name>.csv`` and
    ``repressilator_perf_<name>.csv``.  Returns ``(solver, distribution,
    wall)``."""
    s = common.configure(pt.FspSolverMultiSinks(device=device), bundle,
                         opts, constraint=constraint, bounds=bounds,
                         factors=factors)
    d, wall = common.timed_solve(s, t_final, fsp_tol)
    common.report(f"stage {name}", wall, d, s, prefix="---")
    common.write_marginals(d, out_dir,
                           "repressilator_marginal_{}_" + name + ".csv")
    common.write_step_trace(s, os.path.join(
        out_dir, f"repressilator_perf_{name}.csv"))
    return s, d, wall


def stage_args(name, bundle, adaptive=None):
    """``(constraint, bounds, factors)`` of a stage; the fixed stages take
    the final bounds of their adaptive stage's distribution in
    ``adaptive`` (reference repressilator.cpp:186-195: the space is then
    large enough, so no expansion occurs)."""
    custom = name.endswith("custom")
    if custom:
        bounds, factors = bundle.bounds, bundle.expansion_factors
    else:
        bounds = bundle.bounds_hyperrec
        factors = bundle.expansion_factors_hyperrec
    if name.startswith("fixed"):
        bounds = adaptive.bounds
    return (bundle.constraint if custom else None), bounds, factors


def main(argv=None):
    """All four stages; returns ``{stage: (solver, distribution, wall)}``."""
    opts = common.options(argv)
    device = common.device_of(opts)
    t_final = opts.get_float("t_final", 10.0)
    fsp_tol = opts.get_float("fsp_tol", 1.0e-4)
    out_dir = opts.get("out_dir", "results")
    b = pt.models.repressilator()
    runs = {}
    for name in STAGES:
        adaptive = runs.get(name.replace("fixed", "adaptive"))
        args = stage_args(name, b, adaptive and adaptive[1])
        runs[name] = run_stage(name, b, *args, opts, t_final, fsp_tol,
                               out_dir, device)
    return runs


if __name__ == "__main__":
    main()
