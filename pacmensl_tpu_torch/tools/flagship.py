"""Flagship benchmark: the repressilator's adaptive-custom stage only.

Counterpart of the JAX package's ``tools/flagship.py``: runs the
reference's headline configuration (examples/repressilator.cpp stage 1:
custom product constraints, t_final=10, fsp_tol=1e-4) ``-repeat`` times
and prints each run's wall, the phase report and a last ``walls:`` line.

Usage:
    python -m pacmensl_tpu_torch.tools.flagship [-t_final 10]
        [-fsp_tol 1e-4] [-repeat N] [-device cuda|cpu]
"""
import pacmensl_tpu_torch as pt
from pacmensl_tpu_torch.examples import common


def run_once(opts, t_final, fsp_tol, device="cuda"):
    """One solve; returns ``(solver, distribution, wall)``."""
    s = common.configure(pt.FspSolverMultiSinks(device=device),
                         pt.models.repressilator(), opts)
    d, wall = common.timed_solve(s, t_final, fsp_tol)
    common.report("flagship", wall, d, s)
    return s, d, wall


def main(argv=None):
    """Returns the walls of the runs."""
    opts = common.options(argv)
    device = common.device_of(opts)
    t_final = opts.get_float("t_final", 10.0)
    fsp_tol = opts.get_float("fsp_tol", 1.0e-4)
    repeat = opts.get_int("repeat", 1) if opts.has("repeat") else 1
    walls = []
    for i in range(repeat):
        print(f"--- run {i + 1}/{repeat}")
        walls.append(run_once(opts, t_final, fsp_tol, device)[2])
    print("walls:", " ".join(f"{w:.2f}" for w in walls), flush=True)
    return walls


if __name__ == "__main__":
    main()
