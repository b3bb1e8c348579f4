"""Multi-card scaling sweep.

Counterpart of the JAX package's ``examples/scaling_sweep.py`` (the
reference ``submit_scalability_multi_nodes.sh``: 1-32 MPI ranks x {Block,
Graph} partitioning on the repressilator): times the repressilator's
matvec over n = 1, 2, 4, ... ranks (up to ``-max_devices``) for

* the dense box (``BoxOperator``; K3 on one rank, K4 in one launch
  after the halo exchange over ranks, ``parallel/halo_box.py``), and
* the compressed ELL operator (``EllOperator`` on one rank,
  ``ShardedEllOperator`` over ranks) under BLOCK and GRAPH orderings,

and reports µs per matvec (the slowest rank's, the least of three
rounds of ``-iters`` matvecs), Gnnz/s, parallel
efficiency, the values sent per matvec and the ELL halo width.  On every
n the assembled box dp is checked bitwise against one rank's, and the
ELL dp within 1e-12 relative of one rank's (``"same"``, ``"rel_err"``).

The ranks are processes (``torch.multiprocessing`` spawn): NCCL, one
rank a card, on ``-device cuda``; gloo on ``-device cpu``.  One group of
``max_devices`` ranks runs the whole sweep, its first n ranks forming the
group of each n.

    python -m pacmensl_tpu_torch.examples.scaling_sweep [-max_devices N]
        [-iters 50] [-bound 63] [-device cuda|cpu]
"""
import time

import numpy as np
import torch
import torch.distributed as dist

import pacmensl_tpu_torch as pt
from pacmensl_tpu_torch.examples import common
from pacmensl_tpu_torch.parallel.mesh import StateMesh, gather_global
from pacmensl_tpu_torch.parallel.spawn import run_on_mesh
from pacmensl_tpu_torch.statespace.partitioner import (
    PartitioningType, StatePartitioner)

#: timing rounds of ``-iters`` matvecs each; the least is reported
ROUNDS = 3


def _time(act, mesh, iters, dev) -> float:
    """Seconds per ``act()``: the least over ``ROUNDS`` rounds of
    ``iters`` calls of the slowest rank of ``mesh`` (None: this rank
    alone), after one warm-up call, the ranks aligned by a barrier before
    each round."""
    act()
    best = float("inf")
    for _ in range(ROUNDS):
        if mesh is not None:
            dist.barrier(group=mesh.group)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            act()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = torch.tensor([(time.perf_counter() - t0) / iters],
                          dtype=torch.float64, device=dev)
        if mesh is not None:
            dt = mesh.all_gather(dt).max()
        best = min(best, float(dt))
    return best


def _groups(sizes):
    """The group of the first n ranks for each n of ``sizes`` (None for
    one rank); every rank makes every group."""
    return {n: dist.new_group(list(range(n))) if n > 1 else None
            for n in sizes}


def _sub_mesh(mesh, group, n):
    return StateMesh(group, mesh.rank, n, mesh.device)


def sweep_rank(mesh, bound=63, iters=50, max_devices=None):
    """One rank's part of the sweep over ``mesh``'s ranks: ``{"rows":
    [dict, ...] on rank 0, else [], "launches": this rank's box kernel
    launches by mode}``."""
    from pacmensl_tpu_torch.ops import box_kernel as bk
    bk.KERNEL.reset_counts()
    max_dev = min(int(max_devices or mesh.size), mesh.size)
    sizes = [1 << k for k in range(max_dev.bit_length())
             if 1 << k <= max_dev]
    groups = _groups(sizes)
    b = pt.models.repressilator()
    dev = mesh.device
    rows = []

    def emit(row):
        rows.append(row)
        print(f"devices={row['n']:2d} [{row['label']:14s}] "
              f"{row['us']:9.1f} us/matvec {row['gnnz']:8.3f} Gnnz/s  "
              f"eff={row['eff']:6.1%}  " + (
                  f"comm={row['comm']} vals/mv  same={row['same']}"
                  if row["path"] == "box" else
                  f"halo={row['halo']}  sent={row['comm']} vals/mv  "
                  f"rel_err={row['rel_err']:.1e}"), flush=True)

    # ---- the dense box (hyper-rectangle stage of the reference bench)
    cs = pt.ConstraintSet(None, np.array([bound] * 3), np.full(3, 0.2))
    space = pt.BoxStateSpace(b.model.stoichiometry, cs, b.x0, device=dev,
                             pad_quanta=[max_dev, 1, 1])
    if mesh.rank == 0:
        print(f"== box operator (K3 on one rank, K4 over ranks): "
              f"{space.num_states} states in the capacity "
              f"{tuple(space.shape)} ==", flush=True)
    rng = np.random.default_rng(0)
    p = torch.as_tensor(rng.random(space.size), device=dev) \
        * space.mask.reshape(-1)
    ref, base = None, None
    for n in sizes:
        if mesh.rank < n:
            sub = _sub_mesh(mesh, groups[n], n) if n > 1 else None
            op = pt.BoxOperator(b.model, space, mesh=sub)
            lo = (op.sharded.origin0 + op.sharded.w0) * op.sharded.plane \
                if sub is not None else 0
            y = pt.FspVector(p=p[lo:lo + op.local_n].contiguous(),
                             sinks=None)
            dt = _time(lambda: op.action(0.0, y), sub, iters, dev)
            d = op.action(0.0, y)
            dp = gather_global(d.p, sub) if sub is not None else d.p
            if mesh.rank == 0:
                if ref is None:
                    ref = (dp, d.sinks)
                thr = op.nnz() / dt
                base = base or thr
                emit({"path": "box", "n": n,
                      "label": "K4" if n > 1 else "K3", "us": dt * 1e6,
                      "gnnz": thr / 1e9, "eff": thr / (base * n),
                      "comm": (op.sharded.comm_values_per_matvec()
                               if sub is not None else 0),
                      "same": bool(torch.equal(dp, ref[0])),
                      "sinks_rel": float(
                          ((d.sinks - ref[1]).abs()
                           / ref[1].abs().clamp_min(1e-300)).max())})
            del op, y, d, dp
        dist.barrier()
    del space, p, ref

    # ---- the compressed ELL path, BLOCK against GRAPH
    if mesh.rank == 0:
        print("== ELL operator (halo exchange by all-to-all) ==", flush=True)
    csq = pt.ConstraintSet(b.constraint, b.bounds * 4, b.expansion_factors)
    for ptype in ("block", "graph"):
        ss = pt.StateSet(b.model.stoichiometry, csq, init_states=b.x0)
        ss.expand()
        if ptype == "graph":
            res = StatePartitioner(PartitioningType.GRAPH).partition(
                ss.states, b.model.stoichiometry, max_dev,
                state2index=ss.state2index)
            ss.reorder(res.order)
        ns = ss.num_states
        pv = np.random.default_rng(0).random(ns)
        ref, base = None, None
        for n in sizes:
            if mesh.rank < n:
                sub = _sub_mesh(mesh, groups[n], n) if n > 1 else None
                op = (pt.EllOperator(b.model, ss, device=dev) if sub is None
                      else pt.ShardedEllOperator(b.model, ss, sub))
                full = torch.zeros(op.n_pad, dtype=torch.float64, device=dev)
                full[:ns] = torch.as_tensor(pv, device=dev)
                L = op.local_n
                lo = mesh.rank * L if sub is not None else 0
                y = pt.FspVector(p=full[lo:lo + L].contiguous(), sinks=None)
                dt = _time(lambda: op.action(0.0, y), sub, iters, dev)
                d = op.action(0.0, y)
                dp = (gather_global(d.p, sub) if sub is not None
                      else d.p)[:ns]
                if mesh.rank == 0:
                    if ref is None:
                        ref = dp
                    thr = op.nnz() / dt
                    base = base or thr
                    emit({"path": "ell", "n": n, "label": ptype, "us": dt * 1e6, "gnnz": thr / 1e9,
                          "eff": thr / (base * n),
                          "halo": getattr(op, "halo_width", 0),
                          "comm": (op.values_sent_per_matvec()
                                   if sub is not None else 0),
                          "rel_err": float((dp - ref).abs().max()
                                           / ref.abs().max())})
                del op, y, d, dp, full
            dist.barrier()
    return {"rows": rows, "launches": dict(bk.KERNEL.launches)}


def main(argv=None):
    """Spawns the ranks and runs the sweep; returns ``{"rows": rank 0's
    rows, "launches": the box kernel's launches by mode over every
    rank}``."""
    opts = common.options(argv)
    device = common.device_of(opts)
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    max_dev = opts.get_int("max_devices", cards)
    res = run_on_mesh(sweep_rank, max_dev, device.type,
                      bound=opts.get_int("bound", 63),
                      iters=opts.get_int("iters", 50), max_devices=max_dev)
    launches = {}
    for r in res:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"rows": res[0]["rows"], "launches": launches}


if __name__ == "__main__":
    main()
