"""What the example scripts and the benchmark tools share: the device
option, the timed solve, the report and the output files (the reference
scripts' CSVs, by the same names and columns)."""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import resolve_device
from ..sys.options import Options

#: the per-step CSV's columns (reference FiniteProblemSolverPerfInfo)
STEP_HEADER = "model_time,step_h,m_or_order,n_eqs,epoch_wall"


def options(argv=None) -> Options:
    """PETSc-style options from ``argv`` (default: ``sys.argv[1:]``)."""
    return Options.from_argv(argv)


def device_of(opts: Options) -> torch.device:
    """``-device`` (default ``cuda``); CUDA on a host without it raises
    :class:`~..sys.errors.SetupError`."""
    return resolve_device(opts.get("device", "cuda"))


def timed_solve(s, *args):
    """``(distribution, wall)`` of ``s.solve(*args)``, the wall ended by a
    synchronisation of the solver's card."""
    t0 = time.perf_counter()
    d = s.solve(*args)
    if s.device.type == "cuda":
        torch.cuda.synchronize(s.device)
    return d, time.perf_counter() - t0


def report(tag: str, wall: float, d, s, prefix: str = "===") -> None:
    """The reference scripts' summary line and the solver's event log."""
    head = f"{prefix} {tag}" if prefix else tag
    print(f"{head}: wall {wall:.2f}s  n_states {d.num_states}  "
          f"bounds {np.asarray(d.bounds).tolist()}  mass {d.sum():.6f}")
    print(s.get_event_log().report(), flush=True)


def write_marginals(d, out_dir: str, pattern: str) -> None:
    """Each species' marginal as one CSV column, ``pattern.format(i)``."""
    os.makedirs(out_dir, exist_ok=True)
    for i in range(d.num_species):
        np.savetxt(os.path.join(out_dir, pattern.format(i)), d.marginal(i),
                   delimiter=",")


def write_step_trace(s, path: str) -> None:
    """The solver's per-step trace (``s.step_trace``) as a CSV."""
    tr = s.step_trace
    np.savetxt(path, np.column_stack([tr.model_time, tr.step_h, tr.aux,
                                      tr.n_eqs, tr.wall_time]),
               delimiter=",", header=STEP_HEADER)


def configure(s, bundle, opts: Options, constraint=True, bounds=None,
              factors=None):
    """The reference scripts' set-up: options, model, the bundle's custom
    constraints (``constraint=True``) or a given function (None: the
    default hyper-rectangle), bounds, expansion factors and the initial
    distribution."""
    s.set_from_options(opts)
    s.set_model(bundle.model)
    fn = bundle.constraint if constraint is True else constraint
    if fn is not None:
        s.set_constraint_functions(fn)
    s.set_initial_bounds(bundle.bounds if bounds is None else bounds)
    s.set_expansion_factors(bundle.expansion_factors if factors is None
                            else factors)
    s.set_initial_distribution(bundle.x0, bundle.p0)
    return s
