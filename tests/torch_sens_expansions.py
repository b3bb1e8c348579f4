"""hog1p_5d_sens on the box in both packages on the CPU: each expansion's
epoch, time, grown bounds and rounds, and the box's axis order, capacity
and state count after it, up to a number of expansions.  The port and the
reference package must print the same records (the reference runs one
integrator dispatch an epoch, as the port does).

    python tests/torch_sens_expansions.py [--tol 1e-6] [--expansions 5]

At fsp_tol 1e-6 the second expansion is a reordered rebuild; the run
takes a few minutes on a few CPU cores.  Not a test: too slow for the
tier-1 run.
"""
import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


class _Done(Exception):
    pass


def _recording(base, n):
    class Recording(base):
        def _expand(self, to_expand, rounds=1):
            ev = self.events.events.get("ODESolve")
            t = self._t_now
            out = super()._expand(to_expand, rounds)
            inv = getattr(self, "_axis_inv", None)
            order = (list(range(self.model.num_species)) if inv is None
                     else np.asarray(self._axis_order).tolist())
            self.records.append((
                ev.count if ev else 0, round(float(t), 4),
                np.flatnonzero(np.asarray(to_expand)).tolist(), rounds,
                order, tuple(int(x) for x in self._space.shape),
                int(self._space.num_states)))
            if len(self.records) >= n:
                raise _Done
            return out
    return Recording


def _one_dispatch(cls):
    """The reference driver with one integrator dispatch per epoch (its
    matvec budget per dispatch restarts BDF mid-epoch)."""
    class OneDispatch(cls):
        def _make_ode_solver(self, *args):
            solver = super()._make_ode_solver(*args)
            inner = solver.solve

            def solve(*a, mv_budget=None, **kw):
                return inner(*a, mv_budget=1 << 30, **kw)
            solver.solve = solve
            return solver
    return OneDispatch


def run(pkg_name, tol, n):
    if pkg_name == "port":
        import pacmensl_tpu_torch as pkg
        cls, kw = pkg.SensFspSolverMultiSinks, {"device": "cpu",
                                                "odes_type": "auto"}
    else:
        import jax
        jax.config.update("jax_platforms", "cpu")
        import pacmensl_tpu as pkg
        from pacmensl_tpu.sensfsp.sens_solver import SensFspSolverMultiSinks
        cls, kw = _one_dispatch(SensFspSolverMultiSinks), {"pallas": False}
    b = pkg.models.hog1p_5d_sens()
    s = _recording(cls, n)(backend="box", **kw)
    s.records = []
    s.set_model(b.model)
    s.set_constraint_functions(b.constraint)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors(b.expansion_factors)
    s.set_initial_distribution(b.x0, b.p0)
    try:
        s.solve(180.0, tol)
    except _Done:
        pass
    return s.records, s.events.events["RHSEvaluation"].count


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--expansions", type=int, default=5)
    args = ap.parse_args()
    import torch
    torch.set_num_threads(4)
    out = {}
    for name in ("port", "reference"):
        out[name] = run(name, args.tol, args.expansions)
        for r in out[name][0]:
            print(f"{name}: epoch {r[0]} t {r[1]} grew bounds {r[2]} x{r[3]}"
                  f"; order {r[4]}, capacity {r[5]}, {r[6]} states",
                  flush=True)
        print(f"{name}: RHS evaluations {out[name][1]}", flush=True)
    same = out["port"] == out["reference"]
    print(f"same records and RHS count: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
