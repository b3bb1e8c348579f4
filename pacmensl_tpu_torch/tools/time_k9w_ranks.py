"""Time the batched action on a window (K9w) over ranks, one card each:
one launch after the halo exchange, and the exchange and the launch
apart.

    python <path to this file> [--worlds 2 4] [--nb 3] [--side 128]
                               [--device cuda|cpu]

For each world size (at most the card count), spawns that many ranks
(NCCL, rank r on card r; gloo on ``--device cpu``, a dry run at a small
``--side``), cuts the repressilator's ``side^3`` box (``chip_smoke.py``
phase 11d's shape at 128) into axis-0 slabs, one a rank, and on every
rank times three ways on ``nb`` random vectors of its slab: ``one``,
:meth:`ShardedBoxAction.batched` (the exchange, K9w in one launch on the
window, the all-reduce of the sinks); ``exchange``, the exchange and the
all-reduce alone; ``kernel``, the one launch alone on the halos
received.  CUDA events around REPS calls after WARM calls, the ranks
aligned by a barrier before each, in the order of ORDER, ROUNDS times.
Prints, per world size, one line with each way's ms per call on every
rank (the slowest rank is what a solve waits on), with the card's name
and power limit.
"""
import argparse
import os
import socket
import sys
import time
from pathlib import Path

REPS, WARM, ROUNDS = 100, 10, 3
ORDER = ("one", "exchange", "kernel", "kernel", "exchange", "one")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank, world, port, device, nb, side, out_file):
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import pacmensl_tpu_torch as pt
    from pacmensl_tpu_torch.ops import box_kernel as bk
    from pacmensl_tpu_torch.ops import box_operator as bo
    from pacmensl_tpu_torch.parallel.halo_box import ShardedBoxAction
    cuda = device == "cuda"
    pt.environment.init(backend="nccl" if cuda else "gloo",
                        world_size=world, rank=rank,
                        init_method=f"tcp://127.0.0.1:{port}", timeout=600)
    try:
        mesh = pt.make_mesh(device)
        dev = mesh.device
        rep = pt.models.repressilator()
        shape = (side,) * 3
        cs = pt.ConstraintSet(None, [side - 1] * 3, None, 3)
        props = bo.propensity_tables(rep.model, shape, dev)
        c = rep.model.coefficients(0.0)
        sh = ShardedBoxAction(shape, rep.model.stoichiometry, 3, cs.form,
                              mesh)
        w0, L0, P = sh.w0, sh.L0, sh.plane
        a = props.window(sh.origin0, L0 + 2 * w0)
        bounds = [side - 1] * 3
        gen = torch.Generator(device=dev).manual_seed(7 + rank)
        p = torch.rand((nb, L0 * P), generator=gen, device=dev,
                       dtype=torch.float64)
        up, dn = (torch.zeros((nb, w0 * P), dtype=torch.float64, device=dev)
                  for _ in range(2))

        def exchange():
            mesh.halo_start(p[:, :w0 * P], p[:, (L0 - w0) * P:], up,
                            dn).wait()
            mesh.all_reduce(torch.zeros((nb, 3), dtype=torch.float64,
                                        device=dev))
        runs = {"one": lambda: sh.batched(c, p, a, None, None, bounds),
                "exchange": exchange,
                "kernel": lambda: bk.box_action_synth_batched(
                    c, p, a, bounds, sh.geom, halos=(up, dn))}

        def timed(fn):
            for _ in range(WARM):
                fn()
            if cuda:
                torch.cuda.synchronize()
            dist.barrier()
            if not cuda:
                t0 = time.perf_counter()
                for _ in range(REPS):
                    fn()
                return (time.perf_counter() - t0) * 1e3 / REPS
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(REPS):
                fn()
            e1.record()
            torch.cuda.synchronize()
            return e0.elapsed_time(e1) / REPS
        t = {k: [] for k in runs}
        for _ in range(ROUNDS):
            for k in ORDER:
                t[k].append(timed(runs[k]))
        got = [None] * world
        dist.all_gather_object(got, {"rank": rank, "t": t, "L0": L0,
                                     "w0": w0})
        if rank == 0:
            with open(out_file, "w") as f:
                f.write(repr(got))
    finally:
        pt.environment.finalize()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worlds", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--nb", type=int, default=3)
    ap.add_argument("--side", type=int, default=128)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    import ast
    import tempfile
    import torch
    import torch.multiprocessing as mp
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    smi = "cpu"
    if args.device == "cuda":
        from pacmensl_tpu_torch.ops import box_kernel as bk
        from pacmensl_tpu_torch.tools.timing import card
        bk.KERNEL.load()     # built once, before the ranks load it
        smi = card()
        cards = torch.cuda.device_count()
        if max(args.worlds) > cards:
            raise SystemExit(f"{max(args.worlds)} ranks need as many cards; "
                             f"{cards} here")
    for world in args.worlds:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "ranks.txt")
            mp.spawn(_rank, args=(world, _free_port(), args.device, args.nb,
                                  args.side, out), nprocs=world, join=True)
            got = ast.literal_eval(open(out).read())
        ways = ("one", "exchange", "kernel")
        print(f"K9w over {world} {'nccl' if args.device == 'cuda' else 'gloo'}"
              f" ranks, {args.side}^3 repressilator box, slabs of "
              f"{got[0]['L0']} rows (w0 {got[0]['w0']}), nb={args.nb}, "
              f"ms per call (order {' '.join(ORDER)}, {ROUNDS} rounds; "
              "per rank): " + "; ".join(
                  f"{k} " + ", ".join(
                      "/".join(f"{x:.4f}" for x in g["t"][k]) for g in got)
                  for k in ways)
              + "; slowest rank's mean: " + ", ".join(
                  f"{k} {max(sum(g['t'][k]) / len(g['t'][k]) for g in got):.4f}"
                  for k in ways)
              + f"; {smi}", flush=True)


if __name__ == "__main__":
    main()
