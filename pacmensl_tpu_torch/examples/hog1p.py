"""hog1p 5-species MAPK benchmark script.

Counterpart of the JAX package's ``examples/hog1p.py`` (the reference
``examples/hog1p.cpp``): time-varying gene activation signal, t_final =
180 s, fsp_tol = 1e-4, custom constraints (with a hyper-rectangle
variant), marginal and per-step CSVs.

Usage:
    python -m pacmensl_tpu_torch.examples.hog1p [-fsp_odes_type
        cvode|petsc|krylov] [-t_final 180] [-fsp_tol 1e-4] [-hyperrec]
        [-out_dir results] [-device cuda|cpu]
"""
import os

import pacmensl_tpu_torch as pt
from pacmensl_tpu_torch.examples import common


def main(argv=None):
    """Returns ``(solver, distribution, wall)``."""
    opts = common.options(argv)
    device = common.device_of(opts)
    t_final = opts.get_float("t_final", 180.0)
    fsp_tol = opts.get_float("fsp_tol", 1.0e-4)
    out_dir = opts.get("out_dir", "results")
    hyperrec = opts.get_bool("hyperrec", False)

    b = pt.models.hog1p_5d()
    s = pt.FspSolverMultiSinks(odes_type="cvode",   # tv model: BDF default
                               device=device)
    if hyperrec:
        common.configure(s, b, opts, constraint=None,
                         bounds=b.bounds_hyperrec,
                         factors=b.expansion_factors_hyperrec)
    else:
        common.configure(s, b, opts)
    d, wall = common.timed_solve(s, t_final, fsp_tol)
    common.report("hog1p", wall, d, s, prefix="")
    common.write_marginals(d, out_dir, "hog1p_marginal_{}.csv")
    common.write_step_trace(s, os.path.join(out_dir, "hog1p_perf.csv"))
    return s, d, wall


if __name__ == "__main__":
    main()
