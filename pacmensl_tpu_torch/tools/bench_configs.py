"""Run any of BASELINE.json's five benchmark configs end to end on the
port.

Counterpart of the JAX package's ``tools/bench_configs.py``: each config
mirrors its reference script (file:line cited below) and prints the wall,
state count, mass and the per-phase event report.

Usage:
    python -m pacmensl_tpu_torch.tools.bench_configs <config> [-repeat N]
        [-device cuda|cpu] [common options]
  configs: repressilator | hog1p | transcr6d | sens_hog1p | stationary_rep

Each ``run_<config>(opts, device)`` returns ``(solver, distribution,
wall)``.
"""
import sys

import pacmensl_tpu_torch as pt
from pacmensl_tpu_torch.examples import common


def _run(tag, s, bundle, opts, *solve_args, constraint=True):
    common.configure(s, bundle, opts, constraint=constraint)
    d, wall = common.timed_solve(s, *solve_args)
    common.report(tag, wall, d, s)
    return s, d, wall


def run_repressilator(opts, device="cuda"):
    """examples/repressilator.cpp:131-133,162-165 (adaptive, custom)."""
    return _run("repressilator", pt.FspSolverMultiSinks(device=device),
                pt.models.repressilator(), opts,
                opts.get_float("t_final", 10.0),
                opts.get_float("fsp_tol", 1e-4))


def run_hog1p(opts, device="cuda"):
    """examples/hog1p.cpp:150-158: t_final=180, tol 1e-4, tv signal."""
    return _run("hog1p_5d", pt.FspSolverMultiSinks(odes_type="cvode",
                                                   device=device),
                pt.models.hog1p_5d(), opts,
                opts.get_float("t_final", 180.0),
                opts.get_float("fsp_tol", 1e-4))


def run_transcr6d(opts, device="cuda"):
    """examples/transcr_reg_6d.cpp:128-129: t_final=300, tol 1e-4."""
    return _run("transcr_reg_6d", pt.FspSolverMultiSinks(odes_type="cvode",
                                                         device=device),
                pt.models.transcription_regulation_6d(), opts,
                opts.get_float("t_final", 300.0),
                opts.get_float("fsp_tol", 1e-4), constraint=None)


def run_sens_hog1p(opts, device="cuda"):
    """BASELINE.json config 4: forward sensitivity on hog1p (trans,
    gamma); the plain solve's protocol (examples/hog1p.cpp:150-158).  The
    5-species model by default; ``-model3d`` for the 3-species one."""
    b = (pt.models.hog1p_3d_sens() if opts.has("model3d")
         else pt.models.hog1p_5d_sens())
    out = _run("sens_hog1p", pt.SensFspSolverMultiSinks(odes_type="cvode",
                                                        device=device),
               b, opts, opts.get_float("t_final", 180.0),
               opts.get_float("fsp_tol", 1e-4))
    d = out[1]
    for j in range(d.num_parameters):
        print(f"  dP/dtheta_{j} sum = {d.dp[j].sum():+.3e}")
    return out


def run_stationary_rep(opts, device="cuda"):
    """BASELINE.json config 5: stationary FSP on the repressilator."""
    return _run("stationary_repressilator",
                pt.StationaryFspSolverMultiSinks(device=device),
                pt.models.repressilator(), opts,
                opts.get_float("sfsp_tol", 1e-6))


CONFIGS = {
    "repressilator": run_repressilator,
    "hog1p": run_hog1p,
    "transcr6d": run_transcr6d,
    "sens_hog1p": run_sens_hog1p,
    "stationary_rep": run_stationary_rep,
}


def main(argv=None):
    """``argv``: the config's name, then its options (default:
    ``sys.argv[1:]``).  Returns the runs' ``(solver, distribution,
    wall)``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    name = argv[0] if argv else "repressilator"
    opts = common.options(argv[1:])
    device = common.device_of(opts)
    repeat = opts.get_int("repeat", 1) if opts.has("repeat") else 1
    runs = []
    for i in range(repeat):
        print(f"--- {name} run {i + 1}/{repeat}")
        runs.append(CONFIGS[name](opts, device))
    return runs


if __name__ == "__main__":
    main()
