#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pacmensl_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases (each check that fails ends the run with a nonzero exit):

1. Device: the card's name and power limit from ``nvidia-smi``; build (or
   load) the box kernel from ``pacmensl_tpu_torch/csrc`` and print the
   build time.
2. Both modes of the kernel (mask-reading K1, synthesized-mask K3) vs
   their plain PyTorch versions, in float64, on the box shapes of the
   bundled models at small bounds (hog1p_3d at t = 0, 30, 120, hog1p_5d at
   t = 0, 60), after an epoch-style bounds change at fixed capacity, and on
   the fixed-bounds 128^3 repressilator box, where all are timed with CUDA
   events.  In every case ``dp`` is bitwise equal to the plain version's,
   the sinks (summed in another order) agree within rtol 1e-12 /
   atol 1e-13, and two launches give bitwise-equal ``dp`` and sinks.  On
   every box whose mask is constraint-only, K3's ``dp`` and sinks are
   bitwise K1's, with the forms evaluated in int32 (as the wrapper
   chooses for these boxes) and in int64; transcr_reg_6d (not
   constraint-only) selects K1.
3. Poisson oracle: the transient solve of ``models.poisson()`` to t = 10
   on the GPU against the Poisson(2t) pmf.
4. Repressilator with its custom constraints, t = 10, fsp_tol = 1e-4,
   Krylov, float64, with the launches of each kernel mode.  Then both
   modes against their plain versions on the final operator and solution,
   and the same solve with the plain versions in place of the kernels:
   the two distributions must lie within 2 * fsp_tol in L1.
5. hog1p_5d with its custom constraints, t = 180, fsp_tol = 1e-4, the
   default integrator choice (BDF with matrix-free GMRES, the model is
   time-varying), every matvec on K3.  Then K3 against its plain version
   and K1 on the final operator and solution, and the same solve with the
   mask-reading kernel forced, a comparison run whose launches count for
   no path: the two distributions must be bitwise equal (K3's dp and sinks
   are K1's).
6. transcr_reg_6d with its coordinate constraints, t = 30, fsp_tol = 1e-4,
   BDF: reachability prunes its box, so the mask is not constraint-only
   and every matvec runs K1, as the reference package chooses.  Then K1
   against its plain version on the final operator and solution.
7. The sharded box path (K4, the kernel's sharded mode behind a halo
   exchange over ``torch.distributed``):

   a. In this process: the 128^3 box and the repressilator's final
      operator and solution from phase 4, each cut into 4 axis-0 slabs
      whose windows hold the neighbours' halo planes as the exchange
      delivers them.  K4 in both modes on every slab: the assembled dp is
      bitwise the whole box's K1 dp and K3 dp and each slab's dp bitwise
      the plain K4's; the summed sinks lie within 1e-12 relative of the
      whole box's; two launches are bitwise equal.  Timed per slab and
      per sweep of the 4 slabs beside K1 and K3, and against one
      ``torch.mv`` of the same generator as a CSR matrix with the sink
      rows appended (the library yardstick; the port never calls it).
   b. The repressilator solve of phase 4 sharded over one rank per
      visible card (NCCL, ``torch.multiprocessing`` spawn): phase 4's
      checks, and L1 <= 2 * fsp_tol to phase 4's distribution.
   c. Two ranks on one card over gloo (NCCL refuses two ranks on one
      device), the repressilator to t = 2: L1 <= 2 * fsp_tol to a
      one-device solve and a state count within 5% of its, with every
      rank taking the same steps; K4 runs with real halos from the other
      process.  The ranks sum the sinks and the dots in another order
      than one device, and the expansion path is a discrete outcome that
      rounding selects (as in phase 4), so the state sets may differ.

   In 7b and 7c one matvec of the final operator, with the halos the
   ranks exchange, must give the whole box's dp bitwise and its sinks
   within 1e-12 relative.
8. The probes (``csrc/probes.cu``): the stream copy K5 and the probes
   K6-K8 of the box kernel's memory path.  Their path is the port's two
   measurement entry points, ``ops.probes.stream_bandwidth()`` (K5 at 2^26
   float64 elements, 537 MB per buffer) and
   ``python -m pacmensl_tpu_torch.tools.bw_probe --tiles 96``; the
   measured stream must not exceed 1.05 x 3.35 TB/s.  Then each kernel in
   float32 and float64 at the reference's shape (G = 6 blocks of 4096 x
   128, 12.6 MB per float32 buffer, which the L2 holds), at G = 96 (201
   MB, device memory), at an odd size that leaves a scalar tail and at
   the 128^3 box as one block with a plane of halo on each side: its
   output bitwise its plain version's and two launches bitwise equal, K7
   and K8 with random nonzero halos; K5 also so at 2^26 float64.  Timed
   beside the plain versions and the library calls (``copy_`` for K5,
   ``torch.mul`` for K6 and K7; none computes K8), at the reference's
   shape also as a CUDA graph of 100 calls (the device's time without the
   host's per-call cost).  Then K1's, K3's and K4's roofline fractions
   against the measured stream beside the data sheet's, and K8 in float64
   at the 128^3 box with its strides, the p reads of K1 and K3 without
   their propensity work, L2-resident and after a read that evicts L2.

The ``kernels`` record counts each kernel's launches in the paths' own
solves only: K1 and K3 in phases 4, 5 and 6, K4 in phases 7b and 7c (over
all ranks), K5-K8 in phase 8's two entry points.  ``bound_ms`` is the
compulsory bytes of each timed call over the H100's 3.35 TB/s (the larger
bound: the float operations over its 34 TFLOP/s in float64 and 67 in
float32 are far less).

The last two lines of standard output are the card's name and power
limit, then ``{"ok": true, "device": {...}}``; the line before them is the
kernels' JSON record.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

#: the slice: repressilator with its custom constraints
#: (examples/repressilator.cpp:120-133)
SLICE_T_FINAL, SLICE_TOL = 10.0, 1.0e-4
#: its state count in the reference package's CPU float64 solve
#: (BASELINE.md:408)
SLICE_STATES = 1193406
#: edge of the fixed-bounds repressilator box of bench.py:78-98
BENCH_EDGE = 128
#: the hog1p benchmark solve (examples/hog1p.py, BASELINE.json config 2)
HOG_T_FINAL, HOG_TOL = 180.0, 1.0e-4
#: GMRES's relative residual in BDF (float64 default): each step's
#: corrector conserves mass only to about this, relative
GMRES_TOL = 1.0e-10
#: transcr_reg_6d over the first 30 s of its cell cycle, as the reference
#: package's own test solves it (tests/test_fsp_solver.py:110-125;
#: examples/transcr_reg_6d.cpp runs to t = 300)
TR6_T_FINAL, TR6_TOL = 30.0, 1.0e-4
#: phase 7c: the repressilator to this time (its CPU test size)
GLOO_T_FINAL = 2.0
#: slabs the box is cut into in phase 7a
SLABS = 4
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float64 and float32
#: FLOP/s outside the tensor cores
HBM_RATE, F64_RATE, F32_RATE = 3.35e12, 34e12, 67e12
#: phase 8: a measured stream above this is impossible (an L2-resident or
#: elided probe)
STREAM_LIMIT = 1.05 * HBM_RATE
#: phase 8's shapes (G blocks, T rows, H halo rows, L lanes, edge of the
#: box whose strides K8 shifts by): the reference's (tools/bw_probe.py:39),
#: the device-memory one, an odd one that leaves a scalar tail, and the
#: BENCH_EDGE^3 box as one block with a plane of halo on each side (K8
#: there reads p as K1 and K3 do, without their propensity work)
PROBE_SHAPES = {"reference": (6, 4096, 160, 128, 141),
                "hbm": (96, 4096, 160, 128, 141),
                "odd": (3, 37, 5, 33, 7),
                "box": (1, BENCH_EDGE ** 3 // 128, BENCH_EDGE ** 2 // 128,
                        128, BENCH_EDGE)}
#: seconds a phase-7 rank may take before the script stops every rank
RANK_TIMEOUT = 300


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def l1_by_state(d1, d2):
    """L1 distance of two distributions over the union of their states."""
    import numpy as np
    dims = np.maximum(d1.states.max(axis=0), d2.states.max(axis=0)) + 1
    k1 = np.ravel_multi_index(d1.states.T, dims)
    k2 = np.ravel_multi_index(d2.states.T, dims)
    keys, inv = np.unique(np.concatenate([k1, k2]), return_inverse=True)
    diff = np.zeros(keys.size)
    np.add.at(diff, inv[:k1.size], d1.p)
    np.subtract.at(diff, inv[k1.size:], d2.p)
    return float(np.abs(diff).sum())


def free_port():
    """A free TCP port on the loopback interface, for a rendezvous."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def bound(nbytes, flops, rate=F64_RATE):
    """(bound_ms, bound_by): the least time the card takes to move
    ``nbytes`` and do ``flops`` operations at ``rate`` FLOP/s."""
    tb, tf = nbytes / HBM_RATE, flops / rate
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def time_ms(fn, reps=100):
    """ms per call of ``fn``: CUDA events around ``reps`` back-to-back
    calls after 5 warm-up calls."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps=100):
    """ms per call of ``fn`` replayed from a CUDA graph of ``reps`` calls:
    the device's time without the host's cost per call."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def generator_csr(c, mask, a, viol, shape, stoich, nc):
    """The truncated generator at coefficients ``c`` as a CSR matrix of
    ``n + nc`` rows, the sink rows last: the function the box kernel
    computes (``A @ p`` = dp and sinks).  The library yardstick only."""
    import numpy as np
    import torch
    dev = a.device
    n = int(np.prod(shape))
    strides = torch.tensor([int(np.prod(shape[d + 1:]))
                            for d in range(len(shape))], device=dev)
    ext = torch.tensor(shape, device=dev)
    valid = mask != 0
    x = torch.nonzero(valid).squeeze(1)
    crd = (x[:, None] // strides[None, :]) % ext[None, :]
    rows, cols, vals = [x], [x], []
    diag = torch.zeros(x.numel(), dtype=torch.float64, device=dev)
    for r in range(len(c)):
        rate = float(c[r]) * a[r, x]
        diag = diag - rate
        tgt = crd + torch.as_tensor(stoich[r], device=dev)[None, :]
        inb = ((tgt >= 0) & (tgt < ext[None, :])).all(1)
        flat = torch.where(inb, (tgt * strides[None, :]).sum(1), 0)
        ok = inb & valid[flat]
        rows.append(flat[ok])
        cols.append(x[ok])
        vals.append(rate[ok])
        bits = viol[r, x]
        for cc in range(nc):
            sel = ((bits >> cc) & 1) != 0
            rows.append(torch.full((int(sel.sum()),), n + cc, device=dev))
            cols.append(x[sel])
            vals.append(rate[sel])
    vals.insert(0, diag)
    return torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (n + nc, n)).coalesce().to_sparse_csr()


def rank_solve(rank, world, port, backend, t_final, tol, queue):
    """Phase 7b/7c on one rank: the repressilator solve over the mesh of
    ``world`` ranks; puts its summary (and on rank 0 the distribution)
    on ``queue``."""
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import pacmensl_tpu_torch as pt
    from pacmensl_tpu_torch.ops import box_kernel as bk
    pt.environment.init(backend=backend, world_size=world, rank=rank,
                        init_method=f"tcp://127.0.0.1:{port}",
                        timeout=RANK_TIMEOUT)
    try:
        mesh = pt.make_mesh("cuda")
        rep = pt.models.repressilator()
        s = pt.FspSolverMultiSinks(backend="box", odes_type="krylov",
                                   mesh=mesh)
        s.set_model(rep.model)
        s.set_constraint_functions(rep.constraint)
        s.set_initial_bounds(rep.bounds)
        s.set_expansion_factors(rep.expansion_factors)
        s.set_initial_distribution(rep.x0, rep.p0)
        torch.cuda.synchronize()
        bk.KERNEL.reset_counts()
        t0 = time.perf_counter()
        d = s.solve(t_final, tol)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ev = s.get_event_log().events
        tr = s.step_trace
        out = {"rank": rank, "device": str(mesh.device), "wall": wall,
               "launches": dict(bk.KERNEL.launches),
               "plain": dict(bk.KERNEL.plain_cuda_calls),
               "epochs": ev["ODESolve"].count,
               "rhs": ev["RHSEvaluation"].count,
               "halo": ev["HaloValuesPerMatvec"].count,
               "halo_now": s._operator.sharded.comm_values_per_matvec(),
               "capacity": tuple(s._space.shape),
               "steps": (np.array(tr.model_time), np.array(tr.step_h),
                         np.array(tr.aux)),
               "sinks": np.asarray(d.sinks)}
        if rank == 0:
            out.update(states=d.states, p=d.p, bounds=d.bounds)
        # one matvec of the final operator, with the halos the ranks
        # exchange, against the whole box's kernel on rank 0
        from pacmensl_tpu_torch.parallel.mesh import gather_global
        dp = s._operator.action(t_final, s._y)
        dp_all = gather_global(dp.p, mesh)
        p_all = gather_global(s._y.p, mesh)
        if rank == 0:
            one = pt.BoxOperator(rep.model, s._space)
            want = one.action(t_final, pt.FspVector(p=p_all,
                                                    sinks=s._y.sinks))
            out["matvec_dp_bitwise"] = bool(torch.equal(dp_all, want.p))
            out["matvec_sinks_rel"] = float(
                ((dp.sinks - want.sinks).abs()
                 / want.sinks.abs().clamp_min(1e-300)).max())
        queue.put(out)
    finally:
        pt.environment.finalize()


def run_ranks(world, backend, t_final, tol):
    """``rank_solve`` on ``world`` spawned processes; their summaries by
    rank.  A rank that fails or outlasts RANK_TIMEOUT fails the run, and
    every rank is stopped."""
    import queue as queue_mod
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=rank_solve,
                         args=(r, world, port, backend, t_final, tol, q))
             for r in range(world)]
    for pr in procs:
        pr.start()
    out, t0 = {}, time.perf_counter()
    try:
        while len(out) < world:
            try:
                res = q.get(timeout=5)
                out[res["rank"]] = res
            except queue_mod.Empty:
                dead = [pr.exitcode for pr in procs
                        if pr.exitcode not in (None, 0)]
                check(not dead, f"a rank of the {backend} solve exited "
                                f"with {dead}")
                check(time.perf_counter() - t0 < RANK_TIMEOUT,
                      f"the {backend} solve outlasted {RANK_TIMEOUT} s")
        for pr in procs:
            pr.join(timeout=60)
            check(pr.exitcode == 0, f"a rank of the {backend} solve "
                                    f"exited with {pr.exitcode}")
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.terminate()
                pr.join()
    return [out[r] for r in range(world)]


def probe_phase(dev, smi, roofs):
    """Phase 8: the probes K5-K8 on their path (the stream measurement and
    the probe tool, counters set to 0 just before), then each kernel
    against its plain version and timed.  ``roofs`` maps a box kernel
    mode to (ms per matvec, compulsory bytes).  Returns the probes'
    entries of the ``kernels`` record."""
    import numpy as np
    import torch
    from pacmensl_tpu_torch.ops import probes as pr
    from pacmensl_tpu_torch.tools import bw_probe

    # the path: the two measurement entry points
    torch.cuda.synchronize()
    pr.PROBES.reset_counts()
    bw = pr.stream_bandwidth()
    bw_probe.main(["--tiles", str(PROBE_SHAPES["hbm"][0])])
    torch.cuda.synchronize()
    launches = dict(pr.PROBES.launches)
    m = pr.stream_elems()
    print(f"[8] stream_bandwidth(): {bw / 1e9:.1f} GB/s over 2 x {m} "
          f"float64 ({m * 8 / 1e6:.0f} MB per buffer), "
          f"{bw / HBM_RATE:.3f} of the data sheet's "
          f"{HBM_RATE / 1e12:.2f} TB/s; launches on the path {launches}; "
          f"{smi}", flush=True)
    check(bw <= STREAM_LIMIT, f"the measured stream {bw / 1e9:.1f} GB/s "
                              f"exceeds {STREAM_LIMIT / 1e9:.1f} GB/s: the "
                              "probe was L2-resident or elided")
    check(all(v > 0 for v in launches.values()),
          f"a probe kernel was not launched on its path: {launches}")

    def inputs(shape, dtype, seed):
        G, T, H, L, E = PROBE_SHAPES[shape]
        gen = torch.Generator(device=dev).manual_seed(seed)

        def rand(rows):
            return torch.rand((rows, L), generator=gen, device=dev,
                              dtype=dtype) + 0.5
        c = float(np.random.default_rng(seed).uniform(0.5, 2.0))
        return dict(c=c, x=rand(G * T), prev=rand(G * H), next_=rand(G * H),
                    tiles=G, shifts=bw_probe.box_shifts(E))

    def call(name, a, plain=False, out=None):
        fn = getattr(pr, name + ("_reference" if plain else ""))
        if name in ("stream_copy", "scaled_copy"):
            return fn(a["x"], out=out)
        if name == "window_copy":
            return fn(a["c"], a["x"], a["prev"], a["next_"], a["tiles"],
                      out=out)
        return fn(a["c"], a["x"], a["prev"], a["next_"], a["tiles"],
                  a["shifts"], out=out)

    def library(name, a, out):
        if name == "stream_copy":
            return lambda: out.copy_(a["x"])
        if name == "scaled_copy":
            return lambda: torch.mul(a["x"], pr.SCALED_COPY_FACTOR, out=out)
        if name == "window_copy":
            return lambda: torch.mul(a["x"], a["c"], out=out)
        return None                    # no single torch call computes K8

    def compulsory(name, a):
        """(bytes, operations): x read and out written; K8 also the halo
        elements its shifts reach, and two operations a shift."""
        n, size = a["x"].numel(), a["x"].element_size()
        if name != "roll_window":
            return 2 * n * size, (0 if name == "stream_copy" else n)
        ks = a["shifts"]
        reach = max(max(ks), 0) + max(-min(ks), 0)
        return (2 * n + a["tiles"] * reach) * size, 2 * len(ks) * n

    # each kernel bitwise its plain version
    err = dict.fromkeys(pr.NAMES, 0.0)
    for dtype in (torch.float32, torch.float64):
        for shape in PROBE_SHAPES:
            a = inputs(shape, dtype, seed=8)
            for name in pr.NAMES:
                got = call(name, a)
                again = call(name, a)
                want = call(name, a, plain=True)
                torch.cuda.synchronize()
                e = float((got - want).abs().max())
                err[name] = max(err[name], e)
                check(bool(torch.isfinite(got).all()),
                      f"{name} {shape} {dtype}: non-finite output")
                check(torch.equal(got, want),
                      f"{name} {shape} {dtype}: not bitwise the plain "
                      f"version's (max abs {e:.3e})")
                check(torch.equal(got, again),
                      f"{name} {shape} {dtype}: two launches differ")
                del got, again, want
            print(f"[8] {shape} {tuple(a['x'].shape)} {dtype}: "
                  + ", ".join(pr.NAMES) + " bitwise their plain versions, "
                  "two launches bitwise equal", flush=True)
            del a
            torch.cuda.empty_cache()

    # times: kernel / plain / library in an interleaved order
    order = ["kernel", "plain", "library", "library", "plain", "kernel"]
    timed = {}
    cases = [(name, shape, dt) for dt in (torch.float32, torch.float64)
             for shape in ("reference", "hbm") for name in pr.NAMES]
    for name, shape, dt in cases:
        a = inputs(shape, dt, seed=9)
        out = torch.empty_like(a["x"])
        runs = {"kernel": lambda: call(name, a, out=out),
                "plain": lambda: call(name, a, plain=True, out=out),
                "library": library(name, a, out)}
        t = {k: [] for k in runs if runs[k] is not None}
        for k in order:
            if k in t:
                t[k].append(time_ms(runs[k]))
        res = {k: float(np.mean(v)) for k, v in t.items()}
        if shape == "reference":
            res["graph"] = graph_ms(runs["kernel"])
            if runs["library"] is not None:
                res["graph_library"] = graph_ms(runs["library"])
        nbytes, ops = compulsory(name, a)
        res["bound"] = bound(nbytes, ops, F32_RATE if dt == torch.float32
                             else F64_RATE)
        timed[name, shape, dt] = res
        lab = "L2-resident" if shape == "reference" else "device memory"
        print(f"[8] {name:<11} {shape:<9} ({lab}) {str(dt)[6:]}: "
              + ", ".join(f"{k} " + " / ".join(f"{v * 1e3:.1f}" for v in vs)
                          for k, vs in t.items())
              + " us"
              + (f"; from a CUDA graph: kernel {res['graph'] * 1e3:.1f} us"
                 if "graph" in res else "")
              + (f", library {res['graph_library'] * 1e3:.1f} us"
                 if "graph_library" in res else "")
              + f"; bound {res['bound'][0] * 1e3:.1f} us "
                f"({res['bound'][1]}; {nbytes / 1e6:.1f} MB)", flush=True)
        del a, out, runs
        torch.cuda.empty_cache()
    # K5 at the stream measurement's own size: checked, then timed
    gen = torch.Generator(device=dev).manual_seed(10)
    x = torch.rand(m, generator=gen, device=dev, dtype=torch.float64) + 0.5
    got, again = pr.stream_copy(x), pr.stream_copy(x)
    want = pr.stream_copy_reference(x)
    torch.cuda.synchronize()
    err["stream_copy"] = max(err["stream_copy"],
                             float((got - want).abs().max()))
    check(torch.equal(got, want), "stream_copy at 2^26 float64: not "
                                  "bitwise the plain version's")
    check(torch.equal(got, again), "stream_copy at 2^26 float64: two "
                                   "launches differ")
    del got, again, want
    print(f"[8] stream_copy at 2^26 float64 (random input): bitwise its "
          f"plain version, two launches bitwise equal", flush=True)
    out = torch.empty_like(x)
    runs = {"kernel": lambda: pr.stream_copy(x, out=out),
            "plain": lambda: pr.stream_copy_reference(x, out=out),
            "library": lambda: out.copy_(x)}
    t = {k: [] for k in runs}
    for k in order:
        t[k].append(time_ms(runs[k]))
    k5 = {k: float(np.mean(v)) for k, v in t.items()}
    k5["bound"] = bound(2 * m * 8, 0)
    print(f"[8] stream_copy at 2^26 float64: " + ", ".join(
        f"{k} " + " / ".join(f"{v * 1e3:.1f}" for v in vs)
        for k, vs in t.items()) + f" us; bound {k5['bound'][0] * 1e3:.1f} "
        f"us; {smi}", flush=True)
    del x, out
    torch.cuda.empty_cache()
    ref = timed["stream_copy", "reference", torch.float32]
    g6 = PROBE_SHAPES["reference"]
    n6 = g6[0] * g6[1] * g6[3]
    print(f"[8] the reference shape's stream (L2-resident, no limit "
          f"applies): {2 * n6 * 4 / ref['kernel'] / 1e6:.1f} GB/s per "
          f"launch, {2 * n6 * 4 / ref['graph'] / 1e6:.1f} GB/s from a CUDA "
          f"graph", flush=True)
    for mode, (ms, nbytes) in roofs.items():
        print(f"[8] {mode} roofline fraction at {BENCH_EDGE}^3: "
              f"{nbytes / bw / (ms * 1e-3):.3f} of the measured stream "
              f"({bw / 1e9:.1f} GB/s), {nbytes / HBM_RATE / (ms * 1e-3):.3f} "
              f"of the data sheet's ({nbytes / 1e6:.1f} MB in "
              f"{ms * 1e3:.1f} us)", flush=True)
    # K8 in float64 at the box's shape and strides: what reading p at six
    # offsets costs K1 and K3, back to back (x and out stay in L2) and
    # after a read of 4x the L2 (x comes from device memory; the read's
    # own time subtracted)
    a = inputs("box", torch.float64, seed=11)
    out = torch.empty_like(a["x"])
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    evict = torch.ones(4 * l2 // 8, dtype=torch.float64, device=dev)
    total = torch.empty((), dtype=torch.float64, device=dev)

    def k8():
        call("roll_window", a, out=out)

    def read():
        torch.sum(evict, dim=0, out=total)

    def read_k8():
        read()
        k8()
    box = {"launch": time_ms(k8), "graph": graph_ms(k8),
           "cold": graph_ms(read_k8) - graph_ms(read)}
    print(f"[8] roll_window float64 at the {BENCH_EDGE}^3 box (shifts "
          f"{a['shifts']}, x {a['x'].numel() * 8 / 1e6:.1f} MB): per launch "
          f"{box['launch'] * 1e3:.1f} us, from a CUDA graph "
          f"{box['graph'] * 1e3:.1f} us (L2-resident), after a read that "
          f"evicts L2 {box['cold'] * 1e3:.1f} us (from a graph); beside "
          + ", ".join(f"{k} {ms * 1e3:.1f} us" for k, (ms, _) in
                      roofs.items()) + f"; {smi}", flush=True)
    del a, out, evict, total
    torch.cuda.empty_cache()

    replaces = {"stream_copy": "bench.py:170",
                "scaled_copy": "tools/bw_probe.py:57",
                "window_copy": "tools/bw_probe.py:75",
                "roll_window": "tools/bw_probe.py:104"}
    entries = []
    for name in pr.NAMES:
        r = k5 if name == "stream_copy" else timed[name, "hbm",
                                                   torch.float32]
        entries.append({
            "name": name, "route": "cuda",
            "source": "pacmensl_tpu_torch/csrc/probes.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": r["kernel"],
            "plain_ms": r["plain"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r.get("library")})
    return entries


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import pacmensl_tpu_torch as pt
    from pacmensl_tpu_torch.ops import box_kernel as bk
    from pacmensl_tpu_torch.ops import box_operator as bo
    dev = torch.device("cuda", 0)

    # ---------------------------------------------------------- phase 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[1] card: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    # every library of the port at once, one nvcc each
    from concurrent.futures import ThreadPoolExecutor
    from pacmensl_tpu_torch.ops import probes as pr
    t0 = time.perf_counter()
    libs = {"box kernel": bk.KERNEL, "probe kernels": pr.PROBES}
    with ThreadPoolExecutor(len(libs)) as ex:
        for f in [ex.submit(lib.load) for lib in libs.values()]:
            f.result()
    for name, lib in libs.items():
        print(f"[1] {name}: built in {lib.build_seconds:.2f} s -> "
              f"{lib.path.name}", flush=True)
        if lib.build_log:
            print(lib.build_log, file=sys.stderr, flush=True)
    print(f"[1] both loaded in {time.perf_counter() - t0:.2f} s", flush=True)

    # ---------------------------------------------------------- phase 2
    rng = np.random.default_rng(1234)
    max_err = {"mask": 0.0, "synth": 0.0, "sharded": 0.0}
    TOL = dict(rtol=1e-12, atol=1e-13)

    def same_twice(label, run):
        """Two launches, bitwise equal and finite; returns the first."""
        kp, ks = run()
        kp2, ks2 = run()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(kp).all() and torch.isfinite(ks).all()),
              f"{label}: non-finite kernel output")
        check(torch.equal(kp, kp2) and torch.equal(ks, ks2),
              f"{label}: two launches differ")
        return kp, ks

    def against_plain(label, mode, got, want):
        kp, ks = got
        rp, rs = want
        err = float(max((kp - rp).abs().max(),
                        (ks - rs).abs().max() if ks.numel() else 0.0))
        check(torch.equal(kp, rp),
              f"{label}: dp is not bitwise the plain version's "
              f"(max abs {err:.3e})")
        check(torch.allclose(ks, rs, **TOL),
              f"{label}: sinks differ, max abs {err:.3e}")
        max_err[mode] = max(max_err[mode], err)
        return err

    def check_mask(phase, label, c, p, mask, a, viol, geom):
        """K1 (launched twice) against its plain version."""
        got = same_twice(label, lambda: bk.box_action(c, p, mask, a, viol,
                                                      geom))
        err = against_plain(label, "mask", got, bk.box_action_reference(
            c, p, mask, a, viol, geom))
        print(f"[{phase}] K1 {label:<38} shape={geom.shape} n={geom.n} "
              f"max_abs_err={err:.3e}", flush=True)
        return got

    def check_synth(phase, label, c, p, a, bounds, geom, k1):
        """K3 (launched twice) against its plain version and against the
        K1 result ``k1`` on the same data: bitwise in dp and sinks."""
        got = same_twice(label, lambda: bk.box_action_synth(c, p, a, bounds,
                                                            geom))
        err = against_plain(label, "synth", got, bk.box_action_synth_reference(
            c, p, a, bounds, geom))
        check(torch.equal(got[0], k1[0]) and torch.equal(got[1], k1[1]),
              f"{label}: K3 is not bitwise K1")
        check(geom.narrow(bounds), f"{label}: expected int32 form arithmetic")
        # the same with the int64 form arithmetic, which the bundles' boxes
        # do not need
        geom.narrow = lambda b: False
        wide = same_twice(label, lambda: bk.box_action_synth(c, p, a, bounds,
                                                             geom))
        del geom.narrow
        check(torch.equal(wide[0], k1[0]) and torch.equal(wide[1], k1[1]),
              f"{label}: K3 with int64 forms is not bitwise K1")
        print(f"[{phase}] K3 {label:<38} shape={geom.shape} n={geom.n} "
              f"max_abs_err={err:.3e}, bitwise K1 (int32 and int64 forms)",
              flush=True)

    def k1_data(op):
        """The mask-reading kernel's inputs for ``op``'s current epoch."""
        return (op.space.mask.reshape(-1).to(torch.uint8),
                bo.violation_bits(op.space.constraints,
                                  op.model.stoichiometry, op.shape, dev))

    def compare(phase, label, op, t, p=None):
        """Every mode that applies to ``op``: K1 always, K3 where the
        mask is constraint-only."""
        mask, viol = k1_data(op)
        if p is None:
            p = torch.as_tensor(rng.random(op.geom.n), device=dev)
            p = torch.where(mask != 0, p,
                            torch.zeros((), device=dev, dtype=p.dtype))
        c = op.model.coefficients(t)
        k1 = check_mask(phase, label, c, p, mask, op.prop_fields, viol,
                        op.geom)
        if op.synth_mask:
            check_synth(phase, label, c, p, op.prop_fields,
                        op.data().bounds, op.geom, k1)

    def operator(bundle, bounds):
        cs = pt.ConstraintSet(bundle.constraint, bounds,
                              bundle.expansion_factors,
                              bundle.model.num_species)
        space = pt.BoxStateSpace(bundle.model.stoichiometry, cs, bundle.x0,
                                 device=dev)
        return bo.BoxOperator(bundle.model, space)

    m = pt.models
    cases = [
        ("poisson", m.poisson(), [50], [0.0]),
        ("toggle", m.toggle(), [12, 9, 40], [0.0]),
        ("repressilator", m.repressilator(), [25, 15, 15, 60, 30, 60],
         [0.0]),
        ("hog1p_3d", m.hog1p_3d(), [3, 8, 8, 4, 12, 12, 12],
         [0.0, 30.0, 120.0]),
        ("hog1p_5d", m.hog1p_5d(), [3, 6, 6, 6, 6, 8, 8], [0.0, 60.0]),
        ("transcr_reg_6d", m.transcription_regulation_6d(),
         [10, 6, 2, 3, 2, 4], [0.0, 600.0]),
    ]
    for name, bundle, bounds, ts in cases:
        op = operator(bundle, np.asarray(bounds))
        if name == "transcr_reg_6d":
            check(not op.space.mask_is_constraint_only and not op.synth_mask,
                  "transcr_reg_6d: expected the mask-reading kernel")
        else:
            check(op.synth_mask, f"{name}: expected the synthesized-mask "
                                 "kernel")
        for t in ts:
            compare(2, f"{name} t={t:g}", op, t)
    # epoch-style bounds change at fixed capacity
    tg = m.toggle()
    op = operator(tg, np.array([16, 9, 40]))
    shape0 = op.shape
    op.space.set_bounds(np.array([18, 9, 41]))
    check(tuple(op.space.shape) == tuple(shape0),
          "toggle epoch change left the capacity")
    op.refresh_data()
    check(op.synth_mask, "toggle epoch change left the synthesized mask")
    compare(2, "toggle, bounds grown in capacity", op, 0.0)

    # the fixed-bounds 128^3 repressilator box (all states valid)
    rep = m.repressilator()
    shape = (BENCH_EDGE,) * 3
    n = int(np.prod(shape))
    bench_bounds = np.array([BENCH_EDGE - 1] * 3)
    cs = pt.ConstraintSet(None, bench_bounds, None, 3)
    geom = bk.BoxGeometry(shape, rep.model.stoichiometry, 3, cs.form)
    a = bo.propensity_fields(rep.model, shape, dev)
    viol = bo.violation_bits(cs, rep.model.stoichiometry, shape, dev)
    mask = torch.ones(n, dtype=torch.uint8, device=dev)
    p = torch.as_tensor(rng.random(n), device=dev)
    c = rep.model.coefficients(0.0)
    k1 = check_mask(2, f"{BENCH_EDGE}^3 repressilator box", c, p, mask, a,
                    viol, geom)
    check_synth(2, f"{BENCH_EDGE}^3 repressilator box", c, p, a,
                bench_bounds, geom, k1)
    del k1

    run = {
        "plain": lambda: bk.box_action_reference(c, p, mask, a, viol, geom),
        "plain_synth": lambda: bk.box_action_synth_reference(
            c, p, a, bench_bounds, geom),
        "K1": lambda: bk.box_action(c, p, mask, a, viol, geom),
        "K3": lambda: bk.box_action_synth(c, p, a, bench_bounds, geom),
    }
    order = ["plain", "plain_synth", "K1", "K3", "K3", "K1", "plain_synth",
             "plain"]
    times = {k: [] for k in run}
    for k in order:
        times[k].append(time_ms(run[k]))
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    print(f"[2] {BENCH_EDGE}^3 repressilator box per matvec (us, 100 calls "
          f"each, order {' '.join(order)}): "
          + ", ".join(f"{k} " + " / ".join(f"{v * 1e3:.1f}" for v in vs)
                      for k, vs in times.items()) + f"; {smi}", flush=True)
    R = rep.model.num_reactions

    def library(label, c, p, mask, a, viol, shape, nc, k1, reps=100):
        """One torch.mv of the generator as CSR on ``p``, checked against
        K1's (dp, sinks) ``k1``; its time in ms over ``reps`` calls."""
        A = generator_csr(c, mask, a, viol, shape, rep.model.stoichiometry,
                          nc)
        y = torch.mv(A, p)
        scale = float(k1[0].abs().max())
        err = max(float((y[:-nc] - k1[0]).abs().max()),
                  float((y[-nc:] - k1[1]).abs().max()))
        check(err <= 1e-9 * scale, f"{label}: the CSR generator differs "
                                   f"from K1 by {err:.3e}")
        t = min(time_ms(lambda: torch.mv(A, p), reps) for _ in range(2))
        print(f"[{label}] library: torch.mv of the CSR generator "
              f"({A.shape[0]} x {A.shape[1]}, {A.values().numel()} "
              f"nonzeros) {t * 1e3:.1f} us, max abs difference to K1 "
              f"{err:.3e}", flush=True)
        del A
        return t

    k1 = bk.box_action(c, p, mask, a, viol, geom)
    lib_ms = library("2", c, p, mask, a, viol, shape, 3, k1)
    flops = 2 * (2 * R + 1) * n
    roof_bytes = {"K1": pr.box_action_bytes(n, n, R, False),
                  "K3": pr.box_action_bytes(n, n, R, True)}
    del k1, run
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 3
    b = m.poisson(2.0)
    s = pt.FspSolverMultiSinks(odes_type="krylov", device=dev)
    s.set_model(b.model)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors([0.5])
    s.set_initial_distribution(b.x0, b.p0)
    t0 = time.perf_counter()
    d = s.solve(10.0, 1.0e-6)
    wall = time.perf_counter() - t0
    k = d.states[:, 0]
    lam = 20.0
    pmf = np.exp(k * math.log(lam) - lam
                 - np.array([math.lgamma(v + 1.0) for v in k]))
    l1 = float(np.abs(d.p - pmf).sum())
    print(f"[3] poisson t=10: {d.num_states} states, L1 to Poisson(20) "
          f"{l1:.3e} (limit 1e-6), {wall:.2f} s", flush=True)
    check(l1 <= 1.0e-6, f"poisson oracle L1 {l1:.3e} > 1e-6")

    # ------------------------------------------------ phases 4 and 5
    def solver_for(bundle, odes_type):
        s = pt.FspSolverMultiSinks(backend="box", odes_type=odes_type,
                                   device=dev)
        s.set_model(bundle.model)
        s.set_constraint_functions(bundle.constraint)
        s.set_initial_bounds(bundle.bounds)
        s.set_expansion_factors(bundle.expansion_factors)
        s.set_initial_distribution(bundle.x0, bundle.p0)
        return s

    def run_solve(phase, label, s, t_final, tol, mass_tol):
        """One solve with the counters set to 0 just before it; prints
        and checks its output; returns (distribution, launches, plain
        calls)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        bk.KERNEL.reset_counts()
        t0 = time.perf_counter()
        d = s.solve(t_final, tol)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(bk.KERNEL.launches)
        plain = dict(bk.KERNEL.plain_cuda_calls)
        peak = torch.cuda.max_memory_allocated(dev)
        ev = s.get_event_log().events
        mass, sinks = d.sum(), np.asarray(d.sinks)
        steps = ev["ODESteps"].count if "ODESteps" in ev else 0
        rej = ev["ODEStepsRejected"].count if "ODEStepsRejected" in ev else 0
        print(f"[{phase}] {label}: {d.num_states} states, bounds "
              f"{d.bounds.tolist()}, capacity {tuple(s._space.shape)}, "
              f"epochs {ev['ODESolve'].count}, RHS evaluations "
              f"{ev['RHSEvaluation'].count}, steps {steps}, rejected {rej}, "
              f"wall {wall:.2f} s, peak device memory {peak / 2**30:.2f} "
              f"GiB, sum(p) {mass:.10f}, sum(sinks) {sinks.sum():.3e}, "
              f"kernel launches {launches}, plain calls on CUDA {plain}",
              flush=True)
        print(s.get_event_log().report(), flush=True)
        check(np.isfinite(d.p).all() and np.isfinite(sinks).all(),
              f"{label}: non-finite solution")
        check(d.p.min() > -1e-12,
              f"{label}: negative probability {d.p.min():.3e}")
        check(mass >= 1.0 - tol, f"{label}: sum(p) = {mass} < 1 - {tol:g}")
        # Sinks count a transition in every constraint it violates, so
        # max(sinks) <= mass that left <= sum(sinks): mass is conserved iff
        # sum(p) + max(sinks) <= 1 <= sum(p) + sum(sinks), to rounding (or
        # to the integrator's own conservation, mass_tol(steps)).
        mt = mass_tol(steps + rej)
        check(mass + sinks.sum() >= 1.0 - mt,
              f"{label}: sum(p) + sum(sinks) - 1 = "
              f"{mass + sinks.sum() - 1:.3e} (tolerance {mt:.1e})")
        check(mass + sinks.max() <= 1.0 + mt,
              f"{label}: sum(p) + max(sinks) - 1 = "
              f"{mass + sinks.max() - 1:.3e} (tolerance {mt:.1e})")
        print(f"[{phase}] {label}: mass balance sum(p) + sum(sinks) - 1 = "
              f"{mass + sinks.sum() - 1:.3e}, sum(p) + max(sinks) - 1 = "
              f"{mass + sinks.max() - 1:.3e}, tolerance {mt:.1e}",
              flush=True)
        check(sum(launches.values()) > 0, f"{label}: no kernel launch")
        check(sum(plain.values()) == 0,
              f"{label}: the plain versions ran {plain} times on CUDA")
        return d, launches, wall

    def final_operator(phase, label, s, t, synth=True):
        """Every mode that applies against its plain version on the final
        operator and solution; the final operator's mode must be
        ``synth``."""
        op = s._operator
        check(op.synth_mask == synth,
              f"{label}: the final operator does not use the "
              f"{'synthesized-mask' if synth else 'mask-reading'} kernel")
        compare(phase, f"{label}: final operator and p", op, t, p=s._y.p)

    # phase 4: repressilator, Krylov
    s = solver_for(rep, "krylov")
    d4, launch4, _ = run_solve(4, f"repressilator t={SLICE_T_FINAL:g} "
                                  f"tol={SLICE_TOL:g}", s, SLICE_T_FINAL,
                               SLICE_TOL, lambda k: 1.0e-8)
    final_operator(4, "repressilator", s, SLICE_T_FINAL)
    op4, p4 = s._operator, s._y.p      # for phase 7a
    del s
    torch.cuda.empty_cache()

    # The same solve with the plain versions in place of the kernels.
    # Their dp is bitwise the kernels' but their sinks are summed in
    # another order, and the sinks enter the Krylov norms and the
    # stop-check, so the two solves may take different expansion paths
    # (PERF.md).  Both are certified to SLICE_TOL, so they must agree
    # within 2 * SLICE_TOL.
    bo.box_action = bk.box_action_reference
    bo.box_action_synth = bk.box_action_synth_reference
    t0 = time.perf_counter()
    sp = solver_for(rep, "krylov")
    dplain = sp.solve(SLICE_T_FINAL, SLICE_TOL)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    bo.box_action = bk.box_action
    bo.box_action_synth = bk.box_action_synth
    evp = sp.get_event_log().events
    del sp
    torch.cuda.empty_cache()
    l1 = l1_by_state(d4, dplain)
    print(f"[4] the same solve with the plain versions: {dplain.num_states} "
          f"states, epochs {evp['ODESolve'].count}, RHS evaluations "
          f"{evp['RHSEvaluation'].count}, wall {wall_plain:.2f} s; L1 to "
          f"the kernels' solution {l1:.3e} (limit {2 * SLICE_TOL:g})",
          flush=True)
    check(l1 <= 2 * SLICE_TOL, f"L1 between the kernels' and the plain "
                               f"versions' solve {l1:.3e} > "
                               f"{2 * SLICE_TOL:g}")
    # The state count is a discrete outcome that rounding selects (each
    # expansion step adds thousands of states), so a change of summation
    # order alone can move it by several percent; the L1 check above is
    # the one on the distribution.
    check(abs(d4.num_states - SLICE_STATES) <= 0.05 * SLICE_STATES,
          f"{d4.num_states} states, not within 5% of {SLICE_STATES}")

    # phase 5: hog1p_5d, auto -> BDF with matrix-free GMRES, K3
    hog = m.hog1p_5d()

    def bdf_mass_tol(steps):
        return max(1.0e-8, GMRES_TOL * steps)

    s = solver_for(hog, "auto")
    d5, launch5, wall5 = run_solve(
        5, f"hog1p_5d t={HOG_T_FINAL:g} tol={HOG_TOL:g}", s, HOG_T_FINAL,
        HOG_TOL, bdf_mass_tol)
    check(isinstance(s._ode_solver, pt.BdfSolver),
          "hog1p_5d did not run the BDF integrator")
    check(launch5["synth"] > 0, "hog1p_5d launched no K3 kernel")
    ev = s.get_event_log().events
    n_solves = (ev["ODESteps"].count + ev["ODEStepsRejected"].count
                + ev["ODESolve"].count)
    print(f"[5] GMRES iterations {ev['RHSEvaluation'].count - n_solves} "
          f"(RHS evaluations less one per step and one per epoch)",
          flush=True)
    final_operator(5, "hog1p_5d", s, HOG_T_FINAL)
    del s
    torch.cuda.empty_cache()

    # The same solve with the mask-reading kernel forced: a comparison
    # run, not a path, so its launches stay out of the kernels record.
    # K3's dp and sinks are bitwise K1's, so the two solves take the same
    # path and must give the same distribution, bit for bit.
    bo.USE_SYNTH_MASK = False
    s = solver_for(hog, "auto")
    d5k1, launch5k1, wall5k1 = run_solve(
        5, "hog1p_5d, mask-reading kernel forced", s, HOG_T_FINAL, HOG_TOL,
        bdf_mass_tol)
    bo.USE_SYNTH_MASK = True
    check(launch5k1["mask"] > 0 and launch5k1["synth"] == 0,
          f"the forced solve launched {launch5k1}")
    del s
    torch.cuda.empty_cache()
    l1 = l1_by_state(d5, d5k1)
    same = (np.array_equal(d5.states, d5k1.states)
            and np.array_equal(d5.p, d5k1.p)
            and np.array_equal(np.asarray(d5.sinks), np.asarray(d5k1.sinks)))
    print(f"[5] K3 solve {wall5:.2f} s, forced-K1 solve {wall5k1:.2f} s "
          f"(comparison run, K1 launches {launch5k1['mask']}, not counted "
          f"for any path); L1 between them {l1:.3e}, bitwise equal "
          f"(states, p, sinks): {same}", flush=True)
    check(same, f"the K3 and the forced-K1 solve differ (L1 {l1:.3e})")

    # phase 6: transcr_reg_6d, auto -> BDF, K1 (the mask is pruned by
    # reachability, so not constraint-only)
    tr6 = m.transcription_regulation_6d()
    s = solver_for(tr6, "auto")
    d6, launch6, _ = run_solve(
        6, f"transcr_reg_6d t={TR6_T_FINAL:g} tol={TR6_TOL:g}", s,
        TR6_T_FINAL, TR6_TOL, bdf_mass_tol)
    check(isinstance(s._ode_solver, pt.BdfSolver),
          "transcr_reg_6d did not run the BDF integrator")
    check(launch6["mask"] > 0, "transcr_reg_6d launched no K1 kernel")
    n0 = int(np.prod(np.asarray(tr6.bounds) + 1))
    check(d6.num_states > n0, f"transcr_reg_6d: {d6.num_states} states, "
                              f"no expansion beyond the initial {n0}")
    final_operator(6, "transcr_reg_6d", s, TR6_T_FINAL, synth=False)
    del s
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 7
    from pacmensl_tpu_torch.parallel.halo_box import halo_width, window_rows

    def slab_windows(geom, p, mask, a, viol):
        """``geom``'s box cut into SLABS axis-0 slabs, each window holding
        its neighbours' halo planes as the exchange delivers them: a list
        of (K4 geometry, p, mask, fields, violation bits)."""
        shape, g0 = geom.shape, geom.shape[0]
        w0 = halo_width(geom.stoich)
        cuts = np.linspace(0, g0, SLABS + 1).astype(int)
        out = []
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            o, rows = int(lo) - w0, int(hi - lo) + 2 * w0
            g = bk.BoxGeometry((rows,) + shape[1:], geom.stoich, geom.nc,
                               geom.form, origin0=o, g0=g0,
                               out_rows=(w0, w0 + int(hi - lo)))

            def win(t):
                return window_rows(t.reshape(shape), o, rows).reshape(-1)
            out.append((g, win(p), win(mask),
                        torch.stack([win(f) for f in a]),
                        torch.stack([win(v) for v in viol])))
        return out

    def k4_launch(mode, c, bounds, w):
        g, wp, wm, wa, wv = w
        if mode == "mask":
            return bk.box_action(c, wp, wm, wa, wv, g)
        return bk.box_action_synth(c, wp, wa, bounds, g)

    def k4_plain(mode, c, bounds, w):
        g, wp, wm, wa, wv = w
        if mode == "mask":
            return bk.box_action_reference(c, wp, wm, wa, wv, g)
        return bk.box_action_synth_reference(c, wp, wa, bounds, g)

    def check_k4(label, c, p, mask, a, viol, bounds, geom, windows):
        """K4 in both modes on every slab against the plain K4, and the
        assembled result against the whole box's K1 and K3."""
        k1 = bk.box_action(c, p, mask, a, viol, geom)
        k3 = bk.box_action_synth(c, p, a, bounds, geom)
        rel = 0.0
        for mode in ("mask", "synth"):
            dps, sk = [], 0
            for i, w in enumerate(windows):
                got = same_twice(f"{label} K4 {mode} slab {i}",
                                 lambda: k4_launch(mode, c, bounds, w))
                against_plain(f"{label} K4 {mode} slab {i}", "sharded", got,
                              k4_plain(mode, c, bounds, w))
                dps.append(got[0])
                sk = sk + got[1]
            dp = torch.cat(dps)
            check(torch.equal(dp, k1[0]) and torch.equal(dp, k3[0]),
                  f"{label}: the assembled K4 {mode} dp is not bitwise the "
                  "whole box's K1 and K3")
            check(torch.allclose(sk, k1[1], rtol=1e-12, atol=0.0),
                  f"{label}: K4 {mode} sinks {sk.tolist()} against the "
                  f"whole box's {k1[1].tolist()}")
            rel = max(rel, float(((sk - k1[1]).abs()
                                  / k1[1].abs().clamp_min(1e-300)).max()))
        print(f"[7a] K4 {label}: {SLABS} slabs of "
              f"{[w[0].out_hi - w[0].out_lo for w in windows]} rows, windows "
              f"of {[w[0].shape[0] for w in windows]}; both modes bitwise "
              f"the plain K4 and the whole box's K1 and K3, summed sinks "
              f"within {rel:.3e} relative, max_abs_err "
              f"{max_err['sharded']:.3e}", flush=True)
        return k1

    def time_k4(label, c, p, mask, a, viol, bounds, geom, windows,
                with_plain):
        """Per-slab and per-sweep K4 times beside K1 and K3 (ms)."""
        run = {
            "K1": lambda: bk.box_action(c, p, mask, a, viol, geom),
            "K3": lambda: bk.box_action_synth(c, p, a, bounds, geom)}
        for mode in ("mask", "synth"):
            run[f"K4_{mode}"] = (lambda m=mode: [
                k4_launch(m, c, bounds, w) for w in windows])
        order = ["K1", "K4_mask", "K4_synth", "K3", "K3", "K4_synth",
                 "K4_mask", "K1"]
        if with_plain:
            run["plain_K4_synth"] = lambda: [
                k4_plain("synth", c, bounds, w) for w in windows]
            order = ["plain_K4_synth"] + order + ["plain_K4_synth"]
        t = {k: [] for k in run}
        for k in order:
            t[k].append(time_ms(run[k], reps=20 if "plain" in k else 100))
        slab = {mode: [time_ms(lambda w=w, m=mode: k4_launch(m, c, bounds,
                                                             w))
                       for w in windows] for mode in ("mask", "synth")}
        print(f"[7a] {label} per matvec (us; order {' '.join(order)}): "
              + ", ".join(f"{k} " + " / ".join(f"{v * 1e3:.1f}" for v in vs)
                          for k, vs in t.items())
              + "; per slab K4 mask "
              + " / ".join(f"{v * 1e3:.1f}" for v in slab["mask"])
              + ", K4 synth "
              + " / ".join(f"{v * 1e3:.1f}" for v in slab["synth"])
              + f"; {smi}", flush=True)
        return {k: float(np.mean(v)) for k, v in t.items()}

    # 7a: the 128^3 box of phase 2
    win128 = slab_windows(geom, p, mask, a, viol)
    check_k4(f"{BENCH_EDGE}^3 box", c, p, mask, a, viol, bench_bounds, geom,
             win128)
    ms4 = time_k4(f"{BENCH_EDGE}^3 box", c, p, mask, a, viol, bench_bounds,
                  geom, win128, with_plain=True)
    n_win = sum(w[0].n for w in win128)
    roof_bytes["K4"] = pr.box_action_bytes(n_win, n, R, True)
    bounds_ms = {k: bound(v, flops) for k, v in roof_bytes.items()}
    del win128, a, viol, mask, p, geom
    torch.cuda.empty_cache()
    # 7a: the repressilator's final operator and solution of phase 4
    mask4, viol4 = k1_data(op4)
    c4 = op4.model.coefficients(SLICE_T_FINAL)
    b4 = op4.data().bounds
    win4 = slab_windows(op4.geom, p4, mask4, op4.prop_fields, viol4)
    k1_4 = check_k4(f"repressilator final {op4.shape}", c4, p4, mask4,
                    op4.prop_fields, viol4, b4, op4.geom, win4)
    time_k4(f"repressilator final {op4.shape}", c4, p4, mask4,
            op4.prop_fields, viol4, b4, op4.geom, win4, with_plain=False)
    library("7a", c4, p4, mask4, op4.prop_fields, viol4, op4.shape,
            op4.geom.nc, k1_4, reps=10)
    del win4, k1_4, mask4, viol4, op4, p4
    torch.cuda.empty_cache()

    def rank_checks(phase, label, res, tol):
        """The checks of a sharded solve's ranks: every matvec on K4, the
        same steps and sinks on every rank, and phase 4's output checks
        on the distribution; returns the distribution and K4 launches."""
        d = res[0]
        launches = sum(r["launches"]["sharded_mask"]
                       + r["launches"]["sharded_synth"] for r in res)
        for r in res:
            check(r["launches"]["sharded_synth"] > 0,
                  f"{label}: rank {r['rank']} launched no K4")
            check(r["launches"]["mask"] + r["launches"]["synth"] == 0
                  and sum(r["plain"].values()) == 0,
                  f"{label}: rank {r['rank']} launched {r['launches']}, "
                  f"plain versions {r['plain']}")
            check(all(np.array_equal(x, y) for x, y in
                      zip(r["steps"], d["steps"])),
                  f"{label}: rank {r['rank']} took other steps than rank 0")
            check(np.array_equal(r["sinks"], d["sinks"]),
                  f"{label}: rank {r['rank']}'s sinks differ from rank 0's")
        pv, sinks = d["p"], d["sinks"]
        mass = float(pv.sum())
        print(f"[{phase}] {label}: {len(res)} rank(s) on "
              f"{[r['device'] for r in res]}, {pv.size} states, capacity "
              f"{d['capacity']}, epochs {d['epochs']}, RHS evaluations "
              f"{d['rhs']}, steps {d['steps'][0].size} (equal on every "
              f"rank), K4 launches {launches}, wall "
              + " / ".join(f"{r['wall']:.2f}" for r in res)
              + f" s, halo values per matvec at the final capacity "
              f"{d['halo_now']} ({d['halo_now'] * 8 / 1e6:.3f} MB over all "
              f"ranks; the HaloValuesPerMatvec event adds it at each of the "
              f"operator's builds: {d['halo']}), sum(p) {mass:.10f}, "
              f"sum(sinks) {sinks.sum():.3e}", flush=True)
        check(np.isfinite(pv).all() and np.isfinite(sinks).all(),
              f"{label}: non-finite solution")
        check(pv.min() > -1e-12, f"{label}: negative probability "
                                 f"{pv.min():.3e}")
        check(mass >= 1.0 - tol, f"{label}: sum(p) = {mass} < 1 - {tol:g}")
        check(mass + sinks.sum() >= 1.0 - 1e-8
              and mass + sinks.max() <= 1.0 + 1e-8,
              f"{label}: mass balance sum(p) + sum(sinks) - 1 = "
              f"{mass + sinks.sum() - 1:.3e}, sum(p) + max(sinks) - 1 = "
              f"{mass + sinks.max() - 1:.3e}")
        print(f"[{phase}] {label}: one matvec of the final operator with "
              f"the exchanged halos: dp bitwise the whole box's "
              f"{d['matvec_dp_bitwise']}, sinks within "
              f"{d['matvec_sinks_rel']:.3e} relative", flush=True)
        check(d["matvec_dp_bitwise"] and d["matvec_sinks_rel"] <= 1e-12,
              f"{label}: the sharded matvec differs from the whole box's")
        from types import SimpleNamespace
        return SimpleNamespace(states=d["states"], p=pv), launches

    # 7b: the repressilator solve of phase 4, one rank per card, NCCL
    torch.cuda.synchronize()
    world = torch.cuda.device_count()
    d7b, launch7b = rank_checks(
        "7b", f"sharded repressilator t={SLICE_T_FINAL:g} "
              f"tol={SLICE_TOL:g} over NCCL",
        run_ranks(world, "nccl", SLICE_T_FINAL, SLICE_TOL), SLICE_TOL)
    l1 = l1_by_state(d7b, d4)
    same = (np.array_equal(d7b.states, d4.states)
            and np.array_equal(d7b.p, d4.p))
    print(f"[7b] L1 to phase 4's distribution {l1:.3e} (limit "
          f"{2 * SLICE_TOL:g}); bitwise phase 4's (states, p): {same}",
          flush=True)
    check(l1 <= 2 * SLICE_TOL, f"7b: L1 to phase 4 {l1:.3e} > "
                               f"{2 * SLICE_TOL:g}")

    # 7c: two ranks on the one card over gloo, against one device
    d7c, launch7c = rank_checks(
        "7c", f"sharded repressilator t={GLOO_T_FINAL:g} tol={SLICE_TOL:g}"
              " over gloo", run_ranks(2, "gloo", GLOO_T_FINAL, SLICE_TOL),
        SLICE_TOL)
    s = solver_for(rep, "krylov")
    t0 = time.perf_counter()
    d1 = s.solve(GLOO_T_FINAL, SLICE_TOL)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    del s
    l1 = l1_by_state(d7c, d1)
    print(f"[7c] one-device solve (a comparison run): {d1.num_states} "
          f"states, {wall1:.2f} s; same states: "
          f"{np.array_equal(d7c.states, d1.states)}, L1 {l1:.3e} (limit "
          f"{2 * SLICE_TOL:g})", flush=True)
    check(abs(d7c.states.shape[0] - d1.num_states) <= 0.05 * d1.num_states,
          f"7c: {d7c.states.shape[0]} states, not within 5% of the "
          f"one-device solve's {d1.num_states}")
    check(l1 <= 2 * SLICE_TOL, f"7c: L1 to the one-device solve {l1:.3e}")

    # ---------------------------------------------------------- phase 8
    probe_entries = probe_phase(dev, smi, {
        "K1": (ms["K1"], roof_bytes["K1"]), "K3": (ms["K3"], roof_bytes["K3"]),
        "K4": (ms4["K4_synth"], roof_bytes["K4"])})

    paths = (launch4, launch5, launch6)
    print(json.dumps({"kernels": [
        {"name": "box_action", "route": "cuda",
         "source": "pacmensl_tpu_torch/csrc/box_action.cu",
         "replaces": "pacmensl_tpu/ops/pallas_box.py:655",
         "launches": sum(lc["mask"] for lc in paths),
         "max_abs_err": max_err["mask"],
         "ms": ms["K1"], "plain_ms": ms["plain"],
         "bound_ms": bounds_ms["K1"][0], "bound_by": bounds_ms["K1"][1],
         "library_ms": lib_ms},
        {"name": "box_action_synth", "route": "cuda",
         "source": "pacmensl_tpu_torch/csrc/box_action.cu",
         "replaces": "pacmensl_tpu/ops/pallas_box.py:477",
         "launches": sum(lc["synth"] for lc in paths),
         "max_abs_err": max_err["synth"],
         "ms": ms["K3"], "plain_ms": ms["plain_synth"],
         "bound_ms": bounds_ms["K3"][0], "bound_by": bounds_ms["K3"][1],
         "library_ms": lib_ms},
        {"name": "box_action_sharded", "route": "cuda",
         "source": "pacmensl_tpu_torch/csrc/box_action.cu",
         "replaces": "pacmensl_tpu/ops/pallas_box.py:220",
         "launches": launch7b + launch7c,
         "max_abs_err": max_err["sharded"],
         "ms": ms4["K4_synth"], "plain_ms": ms4["plain_K4_synth"],
         "bound_ms": bounds_ms["K4"][0], "bound_by": bounds_ms["K4"][1],
         "library_ms": lib_ms}] + probe_entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
