"""Microbenchmark of the compressed (ELL) backend's action.

Counterpart of the JAX package's ``tools/ell_bench.py``: builds the
custom-constraint repressilator state set at the flagship's final bounds
(times ``BOUND_SCALE``), orders it by GRAPH (reverse Cuthill-McKee, the
locality order), assembles :class:`EllOperator` and reports µs per action
and Gnnz/s.  The port has one gather, the plain one; the reference's
bucket-shift gather dodges the TPU's slow element gather and is not
ported, which the output says.  On a card the time is CUDA events around
``ITERS`` actions (default 96), the least of three rounds; on the host
the host clock.

Usage:
    python -m pacmensl_tpu_torch.tools.ell_bench [BOUND_SCALE]
        [-device cuda|cpu]
"""
import os
import sys
import time

import numpy as np
import torch

import pacmensl_tpu_torch as pt
from pacmensl_tpu_torch.examples import common
from pacmensl_tpu_torch.statespace.partitioner import (
    PartitioningApproach, PartitioningType, StatePartitioner)

#: the flagship's final bounds (BASELINE round-4 runs)
FLAGSHIP_BOUNDS = np.array([147, 147, 177, 5241, 5720, 6290])
ROUNDS = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def time_action(op, y, iters=None, t=0.5) -> float:
    """Seconds per ``op.action(t, y)``: the least over ``ROUNDS`` rounds
    of ``iters`` actions (default ``ITERS`` from the environment, 96)
    after three warm-up actions; CUDA events on a card."""
    iters = iters or int(os.environ.get("ITERS", "96"))
    c = op.coefficients(t)
    out = torch.empty_like(y.p)
    for _ in range(3):
        op.action(t, y, c=c, out=out)
    cuda = y.p.device.type == "cuda"
    best = float("inf")
    for _ in range(ROUNDS):
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(iters):
                op.action(t, y, c=c, out=out)
            ev[1].record()
            ev[1].synchronize()
            dt = ev[0].elapsed_time(ev[1]) * 1e-3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                op.action(t, y, c=c, out=out)
            dt = time.perf_counter() - t0
        best = min(best, dt / iters)
    return best


def main(argv=None):
    """Returns ``{"states", "n_pad", "nnz", "us", "gnnz_per_s"}``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    opts = common.options(argv)
    device = common.device_of(opts)
    bounds = FLAGSHIP_BOUNDS
    if argv and not argv[0].startswith("-"):
        bounds = np.ceil(bounds * float(argv[0])).astype(np.int64)
    b = pt.models.repressilator()
    cs = pt.ConstraintSet(b.constraint, bounds, b.expansion_factors)
    t0 = time.perf_counter()
    ss = pt.StateSet(b.model.stoichiometry, cs, init_states=b.x0)
    ss.expand()
    log(f"state set: {ss.num_states} states [{time.perf_counter()-t0:.1f}s]")
    t0 = time.perf_counter()
    part = StatePartitioner(PartitioningType.GRAPH,
                            PartitioningApproach.FROMSCRATCH)
    res = part.partition(ss.states, b.model.stoichiometry, 1,
                         state2index=ss.state2index, need_boundaries=False)
    ss.reorder(res.order)
    log(f"locality order (RCM): [{time.perf_counter()-t0:.1f}s]")
    log("bucket: not ported (the bucket-shift gather is TPU-only); the "
        "port's one gather is the plain one")
    t0 = time.perf_counter()
    op = pt.EllOperator(b.model, ss, device=device)
    log(f"plain: assemble {time.perf_counter()-t0:.1f}s "
        f"n_pad={op.n_pad} nnz={op.nnz()}")
    rng = np.random.default_rng(0)
    p = torch.as_tensor(rng.random(op.n_pad), dtype=op.dtype, device=device)
    y = pt.FspVector(p=p, sinks=torch.zeros(op.num_constraints,
                                             dtype=op.dtype, device=device))
    dt = time_action(op, y)
    log(f"plain: {dt*1e6:.1f} us/matvec -> {op.nnz()/dt/1e9:.2f} Gnnz/s")
    return {"states": ss.num_states, "n_pad": op.n_pad, "nnz": op.nnz(),
            "us": dt * 1e6, "gnnz_per_s": op.nnz() / dt / 1e9}


if __name__ == "__main__":
    main()
