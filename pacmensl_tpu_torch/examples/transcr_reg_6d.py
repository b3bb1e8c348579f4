"""6-species transcription-regulation benchmark script.

Counterpart of the JAX package's ``examples/transcr_reg_6d.py`` (the
reference ``examples/transcr_reg_6d.cpp``): cell-volume growth makes
three reactions time-varying; dynamic expansion from small initial
bounds under the default hyper-rectangle constraints.  On a card the
solve starts on the dense box (K1: reachability prunes the box) and
moves to the compressed backend where its states fill less than
``fsp/solver.py``'s ``BOX_FILL_FLOOR`` of the box.

Usage:
    python -m pacmensl_tpu_torch.examples.transcr_reg_6d [-t_final 300]
        [-fsp_tol 1e-4] [-out_dir results] [-device cuda|cpu]
"""
import pacmensl_tpu_torch as pt
from pacmensl_tpu_torch.examples import common


def main(argv=None):
    """Returns ``(solver, distribution, wall)``."""
    opts = common.options(argv)
    device = common.device_of(opts)
    t_final = opts.get_float("t_final", 300.0)
    fsp_tol = opts.get_float("fsp_tol", 1.0e-4)
    out_dir = opts.get("out_dir", "results")

    b = pt.models.transcription_regulation_6d()
    s = common.configure(pt.FspSolverMultiSinks(odes_type="cvode",
                                                device=device),
                         b, opts, constraint=None)
    d, wall = common.timed_solve(s, t_final, fsp_tol)
    common.report("transcr_reg_6d", wall, d, s, prefix="")
    common.write_marginals(d, out_dir, "transcr6d_marginal_{}.csv")
    return s, d, wall


if __name__ == "__main__":
    main()
