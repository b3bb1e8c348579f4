"""The readings that set the limits of ``correct`` (PERF.md): for each
seed, the program's answer to the cell's first request for that seed
against the plain reference in float64 (a sound run's reading), and the
reference in float32 put in the program's place, against the same (the
control's reading, which has to fail).

    python3 fspbench/control.py --workload <cell> --seeds <n> [<n> ...]
        [--t-final <t>]

Prints one JSON line per seed.  The benchmark's own runs do not run
this."""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def readings(cell_name, seed, device, t_final=None):
    """``(sound, control)`` of one cell: the compared numbers of the
    program's answer to the seed's first request and of the float32
    reference's, each against the float64 reference, with the limits."""
    import torch
    from fspbench.lib import config, runner, traffic
    cell = runner.cell_of(runner.benchmark(), cell_name)
    cfg = config.load(cell["config"])
    mix = traffic.load(cell["traffic"])
    kind = runner.request_kind(mix["request"])
    _, f = next(traffic.requests(seed, cfg.num_reactions))
    if t_final is not None:
        cfg.data["t_final"] = float(t_final)
    t0 = time.perf_counter()
    s, answer = kind.serve(cfg, mix, f, device)
    del s
    t1 = time.perf_counter()
    ref = kind.reference_solve(cfg, mix, f, device, torch.float64)
    t2 = time.perf_counter()
    sound = kind.compare(answer, ref)
    r32 = kind.reference_solve(cfg, mix, f, device, torch.float32)
    t3 = time.perf_counter()
    control = kind.compare(kind.as_answer(r32), ref)
    return {"seed": seed, "t_final": cfg.t_final,
            "limits": kind.limits(cfg), "sound": sound,
            "control": control, "ref_states": ref.box.n,
            "ref_terms": ref.terms, "ref_redone": ref.redone,
            "program_s": t1 - t0, "ref64_s": t2 - t1, "ref32_s": t3 - t2}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--t-final", type=float, default=None,
                    help="solve to this time instead of the "
                    "configuration's")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, "cuda",
                                  args.t_final)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
