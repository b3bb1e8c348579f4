#!/usr/bin/env python3
"""Where the one-rank sharded repressilator solve spends its time, on one
CUDA card, against the unsharded solve (``pacmensl_tpu_torch``).

    python3 tools/torch_sharded_profile.py

Runs the repressilator to t = 10 (fsp_tol 1e-4, Krylov) unsharded and
through the sharded path on a one-rank NCCL group, with the overlap split
and without it (``PACMENSL_HALO_OVERLAP=0``), in the order unsharded,
split, monolithic, monolithic, split, unsharded, and prints each wall.
Then it profiles the first 3 model seconds of the unsharded and the split
solve with ``torch.profiler`` and prints, for each, the device time by
kernel (the top kernel rows of ``key_averages``), the kernels' summed
device time and the wall.  Prints the card's name and power limit.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

T_FINAL, PROFILE_T, ROWS = 10.0, 3.0, 14


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import pacmensl_tpu_torch as pt
    from pacmensl_tpu_torch.ops import box_kernel as bk
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    pt.environment.init(backend="nccl")
    mesh = pt.make_mesh()
    rep = pt.models.repressilator()

    def solve(kind, t_final):
        os.environ["PACMENSL_HALO_OVERLAP"] = "0" if kind == "mono" else "1"
        s = pt.FspSolverMultiSinks(odes_type="krylov", device="cuda",
                                   mesh=None if kind == "unsharded"
                                   else mesh)
        s.set_model(rep.model)
        s.set_constraint_functions(rep.constraint)
        s.set_initial_bounds(rep.bounds)
        s.set_expansion_factors(rep.expansion_factors)
        s.set_initial_distribution(rep.x0, rep.p0)
        torch.cuda.synchronize()
        bk.KERNEL.reset_counts()
        t0 = time.perf_counter()
        d = s.solve(t_final, 1.0e-4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ev = s.get_event_log().events
        launches = {k: v for k, v in bk.KERNEL.launches.items() if v}
        del s
        torch.cuda.empty_cache()
        return wall, d.num_states, ev["RHSEvaluation"].count, launches

    for kind in ("unsharded", "split", "mono", "mono", "split",
                 "unsharded"):
        wall, ns, rhs, launches = solve(kind, T_FINAL)
        print(f"{kind:>9} t={T_FINAL:g}: {wall:.2f} s, {ns} states, "
              f"{rhs} RHS evaluations, launches {launches}", flush=True)

    from torch.profiler import ProfilerActivity, profile
    for kind in ("unsharded", "split"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, ns, rhs, _ = solve(kind, PROFILE_T)
        # kernel rows only: an aten op's row repeats its kernels' time
        rows = [e for e in prof.key_averages()
                if e.device_type.name == "CUDA"
                and e.self_device_time_total > 0]
        rows.sort(key=lambda e: -e.self_device_time_total)
        total = sum(e.self_device_time_total for e in rows) / 1e6
        print(f"profile {kind} t={PROFILE_T:g}: wall {wall:.2f} s "
              f"(under the profiler), {rhs} RHS evaluations, summed "
              f"device time {total:.3f} s", flush=True)
        for e in rows[:ROWS]:
            print(f"  {e.self_device_time_total / 1e6:9.4f} s "
                  f"{e.count:8d}  {e.key[:90]}", flush=True)
    pt.environment.finalize()


if __name__ == "__main__":
    main()
