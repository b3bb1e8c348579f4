#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pacmensl_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases (each check that fails ends the run with a nonzero exit):

1. Device: the card's name and power limit from ``nvidia-smi``; build (or
   load) the box kernel from ``pacmensl_tpu_torch/csrc`` and print the
   build time and each instantiation's registers and spills (``ptxas``).
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
   constraint-only) selects K1.  The kernels read the operators' own
   propensities: every reaction on a table (transcr_reg_6d's reactions 4
   and 6 on field rows), checked and printed with their bytes.  Also the
   host time per launch of K1 and K3 (1,000 calls without a
   synchronisation, on the small hog1p_5d box) and the new compulsory
   bytes beside the field-reading kernel's model.
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
      ``torch.mv`` of each slab's rows of the same generator as a CSR
      matrix with the slab's sink rows appended (the library yardstick,
      per slab and per sweep; the port never calls it).
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
   within 1e-12 relative, and every matvec of the solve makes exactly one
   box launch on one rank (no halo in flight) and two with halos (the
   interior rows, then both edge strips), sinks reduced in the launch.
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
9. Forward sensitivities (``SensFspSolverMultiSinks``):

   a. The batched launch K9 (the box kernel on nb vectors at once, the
      counterpart of the reference package's ``vmap`` over the
      sensitivities) in both modes at the 128^3 box with nb = 2 and 4,
      and on hog1p_5d_sens's final operator with the solve's own
      sensitivities: dp bitwise its plain version's and nb single
      launches', sinks bitwise the single launches' and within 1e-12 of
      the plain version's (relative to each vector's largest), two
      launches bitwise equal.  Timed with CUDA events beside nb single K3
      launches, the plain version and one ``torch.sparse.mm`` of the
      generator as CSR with the ``[n, nb]`` block.
   b. hog1p_5d_sens with its custom constraints, t = 180, fsp_tol =
      1e-4, ``"auto"`` -> BDF, every operator on K3 and on tables:
      phase 5's output checks, one K9 and three K3 launches per action,
      finite ``dp``, L1 of p to phase 5's distribution <= 2 * fsp_tol,
      and the FIM finite, symmetric to 1e-12 relative, its eigenvalues
      >= -1e-10 times the largest.
   c. The reference package's oracle (tests/test_sensfsp.py:225-277):
      hog1p_5d_sens to t = 3 at fsp_tol 1e-6 and ODE tolerances (1e-9,
      1e-14), dP/d(trans) against a central difference of two hog1p_5d
      solves at trans = 0.01 +/- 0.001: relative L1 below 5e-2.

The ``kernels`` record counts each kernel's launches in the paths' own
solves only: K1 and K3 in phases 4, 5, 6 and 9b, K4 in phases 7b and 7c
(over all ranks), K5-K8 in phase 8's two entry points, K9 in phase 9b.
``bound_ms`` is the
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
#: phase 9a: the batches the batched launch K9 is checked and timed at
BATCHES = (2, 4)
#: phase 9c: the reference package's finite-difference oracle
#: (tests/test_sensfsp.py:225-277): t, fsp_tol, BDF's rtol and atol, the
#: step in trans, and the limit on the relative L1 of dP/d(trans)
FD_T_FINAL, FD_TOL, FD_RTOL, FD_ATOL = 3.0, 1.0e-6, 1.0e-9, 1.0e-14
FD_EPS, FD_LIMIT = 1.0e-3, 5.0e-2


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


def generator_csr(c, mask, a, viol, shape, stoich, nc, out_range=None):
    """The truncated generator at coefficients ``c`` as a CSR matrix of
    ``n + nc`` rows, the sink rows last: the function the box kernel
    computes (``A @ p`` = dp and sinks).  With ``out_range = (lo, hi)``, flat
    output elements, only their rows and the sinks of transitions from
    them: the function of one K4 slab.  The library yardstick only."""
    import numpy as np
    import torch
    dev = a.device
    n = int(np.prod(shape))
    lo, hi = out_range if out_range is not None else (0, n)
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
    r, cl, v = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    sink = r >= n
    keep = torch.where(sink, (cl >= lo) & (cl < hi), (r >= lo) & (r < hi))
    r = torch.where(sink, r - n + (hi - lo), r - lo)[keep]
    return torch.sparse_coo_tensor(
        torch.stack([r, cl[keep]]), v[keep],
        (hi - lo + nc, n)).coalesce().to_sparse_csr()


def ptxas_lines(log):
    """One line per box kernel instantiation from ``nvcc -Xptxas -v``'s
    output: its template arguments, registers and spills."""
    import re
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z17box_action_kernelILi"
                      r"(\d+)ELb(\d)E(\w)Lb(\d)ELb(\d)E", line)
        if m:
            name = (f"NCM={m.group(1)} "
                    f"{'synth' if m.group(2) == '1' else 'mask'} "
                    f"F={'int32' if m.group(3) == 'i' else 'int64'} "
                    f"{'grouped' if m.group(4) == '1' else 'one'} rows"
                    f"{', batched' if m.group(5) == '1' else ''}")
            continue
        if name and "spill" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            out.append(f"{name}: {m.group(1)} registers; {spill}")
            name = None
    return out


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
        from pacmensl_tpu_torch.parallel import halo_box
        calls = [0]
        action = halo_box.ShardedBoxAction.__call__

        def counted(self, *args, **kw):
            calls[0] += 1
            return action(self, *args, **kw)
        halo_box.ShardedBoxAction.__call__ = counted
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
               "matvecs": calls[0],
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


def fd_trans_oracle(dev, t_final, tol, rtol, atol, eps):
    """Phase 9c: hog1p_5d_sens's dP/d(trans) at ``t_final`` against a
    central difference of two plain hog1p_5d solves at trans = 0.01 +/-
    ``eps`` (the reference package's own oracle,
    tests/test_sensfsp.py:225-277, on the box backend).  Returns (relative
    L1 of the difference, states, sensitivity wall)."""
    import torch
    import pacmensl_tpu_torch as pt

    def setup(s, bundle):
        s.set_model(bundle.model)
        s.set_constraint_functions(bundle.constraint)
        s.set_initial_bounds(bundle.bounds)
        s.set_expansion_factors(bundle.expansion_factors)
        s.set_initial_distribution(bundle.x0, bundle.p0)
        s.set_ode_tolerances(rtol, atol)
        return s

    hs = pt.models.hog1p_5d_sens()
    t0 = time.perf_counter()
    sd = setup(pt.SensFspSolverMultiSinks(odes_type="auto", device=dev),
               hs).solve(t_final, tol)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def plain(trans):
        base = pt.models.hog1p_5d()
        prop0 = base.model.propensity

        def prop(x, r):
            if r in (5, 6):
                xf = x if x.is_floating_point() else x.to(torch.float64)
                return trans * xf[:, 1 if r == 5 else 2]
            return prop0(x, r)
        base.model = pt.Model(base.model.stoichiometry, prop,
                              base.model.t_coeff, tv_reactions=(2,))
        return setup(pt.FspSolverMultiSinks(odes_type="auto", device=dev),
                     base).solve(t_final, tol)

    dp, dm = plain(0.01 + eps), plain(0.01 - eps)
    keyd = {tuple(x): float(v) for x, v in zip(dp.states, dp.p)}
    keym = {tuple(x): float(v) for x, v in zip(dm.states, dm.p)}
    num = den = 0.0
    for x, g in zip(sd.states, sd.dp[0]):
        k = tuple(x)
        fd = (keyd.get(k, 0.0) - keym.get(k, 0.0)) / (2 * eps)
        num += abs(g - fd)
        den += abs(fd)
    return num / max(den, 1e-300), sd.num_states, wall


def sens_phase(dev, smi, d5, mass_tol, run_solve, tables, same_twice,
               max_err):
    """Phase 9: forward sensitivities.  (a) The batched launch K9 in both
    modes against its plain version and against nb single launches, at
    the 128^3 box with nb in BATCHES and on hog1p_5d_sens's final
    operator; timed beside nb single K3 launches, the plain version and
    one torch.sparse.mm of the generator as CSR with the [n, nb] block.
    (b) hog1p_5d_sens, t = 180, fsp_tol = 1e-4, "auto" -> BDF, K3: the
    output checks of the other solves, the launches of each matvec, L1 of
    p to phase 5's distribution, and the FIM.  (c) The reference
    package's finite-difference oracle.  Returns the solve's launches and
    K9's record at 128^3 and nb = 2."""
    import numpy as np
    import torch
    import pacmensl_tpu_torch as pt
    from pacmensl_tpu_torch.ops import box_kernel as bk
    from pacmensl_tpu_torch.ops import box_operator as bo
    from pacmensl_tpu_torch.ops import probes as pr
    from pacmensl_tpu_torch.ops.sens_operator import SensOperator

    def check_batched(label, c, P, a, geom, bounds=None, mask=None,
                      viol=None):
        """K9 (launched twice; K3 where ``bounds`` are given, else K1)
        against its plain version and against nb single launches: dp
        bitwise both, sinks bitwise the single launches' and within 1e-12
        of each vector's largest plain sink."""
        nb, synth = P.shape[0], bounds is not None
        if synth:
            def run():
                return bk.box_action_synth_batched(c, P, a, bounds, geom)
            plain = bk.box_action_synth_batched_reference(c, P, a, bounds,
                                                          geom)
            one = [bk.box_action_synth(c, P[i], a, bounds, geom)
                   for i in range(nb)]
        else:
            def run():
                return bk.box_action_batched(c, P, mask, a, viol, geom)
            plain = bk.box_action_batched_reference(c, P, mask, a, viol,
                                                    geom)
            one = [bk.box_action(c, P[i], mask, a, viol, geom)
                   for i in range(nb)]
        mode = "K3" if synth else "K1"
        kp, ks = same_twice(f"{label} K9 ({mode})", run)
        rp, rs = plain
        err = float(max((kp - rp).abs().max(), (ks - rs).abs().max()))
        check(torch.equal(kp, rp), f"{label} K9 ({mode}): dp is not bitwise "
                                   f"the plain version's (max abs {err:.3e})")
        scale = rs.abs().amax(dim=1, keepdim=True).clamp_min(1e-300)
        rel = float(((ks - rs).abs() / scale).max())
        check(rel <= 1e-12, f"{label} K9 ({mode}): sinks {rel:.3e} from the "
                            "plain version's, relative")
        check(torch.equal(kp, torch.stack([o[0] for o in one]))
              and torch.equal(ks, torch.stack([o[1] for o in one])),
              f"{label} K9 ({mode}): not bitwise {nb} single launches")
        max_err["batched"] = max(max_err["batched"], err)
        print(f"[9a] K9 ({mode}) {label}: nb={nb}, shape={geom.shape}; dp "
              f"bitwise the plain version's and {nb} single launches', "
              f"sinks bitwise the single launches' and within {rel:.3e} of "
              f"the plain version's (relative), max_abs_err {err:.3e}",
              flush=True)

    def timed(label, runs, order, reps):
        t = {k: [] for k in runs}
        for k in order:
            t[k].append(time_ms(runs[k], reps=reps.get(k, 100)))
        print(f"[9a] {label} (us; order {' '.join(order)}): " + ", ".join(
            f"{k} " + " / ".join(f"{v * 1e3:.1f}" for v in vs)
            for k, vs in t.items()) + f"; {smi}", flush=True)
        return {k: float(np.mean(v)) for k, v in t.items()}

    # (a) the 128^3 repressilator box of phase 2
    rep = pt.models.repressilator()
    shape = (BENCH_EDGE,) * 3
    n = int(np.prod(shape))
    stoich = rep.model.stoichiometry
    R = stoich.shape[0]
    bb = np.array([BENCH_EDGE - 1] * 3)
    cs = pt.ConstraintSet(None, bb, None, 3)
    geom = bk.BoxGeometry(shape, stoich, 3, cs.form)
    a = bo.propensity_tables(rep.model, shape, dev)
    viol = bo.violation_bits(cs, stoich, shape, dev)
    mask = torch.ones(n, dtype=torch.uint8, device=dev)
    c = rep.model.coefficients(0.0)
    gen = torch.Generator(device=dev).manual_seed(9)
    k9 = None
    for nb in BATCHES:
        P = torch.rand((nb, n), generator=gen, device=dev,
                       dtype=torch.float64)
        label = f"{BENCH_EDGE}^3 repressilator box"
        check_batched(label, c, P, a, geom, bounds=bb)
        check_batched(label, c, P, a, geom, mask=mask, viol=viol)
        A = generator_csr(c, mask, a.dense(), viol, shape, stoich, 3)
        Pt = P.T.contiguous()
        y = torch.sparse.mm(A, Pt)
        kp, ks = bk.box_action_synth_batched(c, P, a, bb, geom)
        lerr = max(float((y[:n].T - kp).abs().max()),
                   float((y[n:].T - ks).abs().max()))
        check(lerr <= 1e-9 * float(kp.abs().max()),
              f"128^3 nb={nb}: the CSR generator differs from K9 by "
              f"{lerr:.3e}")
        runs = {
            "plain": lambda: bk.box_action_synth_batched_reference(
                c, P, a, bb, geom),
            "single": lambda: [bk.box_action_synth(c, P[i], a, bb, geom)
                               for i in range(nb)],
            "K9": lambda: bk.box_action_synth_batched(c, P, a, bb, geom),
            "K9_K1": lambda: bk.box_action_batched(c, P, mask, a, viol,
                                                   geom),
            "library": lambda: torch.sparse.mm(A, Pt)}
        ms = timed(f"{label} nb={nb} per call: K9 (K3), {nb} single K3 "
                   f"launches, K9 (K1), plain, torch.sparse.mm of the CSR "
                   f"generator ({A.values().numel()} nonzeros) with the "
                   f"[n, {nb}] block", runs,
                   ["plain", "single", "K9", "K9_K1", "library", "library",
                    "K9_K1", "K9", "single", "plain"], {"plain": 10})
        tb = a.table_bytes()
        nbytes = nb * pr.box_action_bytes(n, n, R, True) + tb
        bnd = bound(nbytes, nb * 2 * (2 * R + 1) * n)
        print(f"[9a] {label} nb={nb}: K9 {ms['K9'] * 1e3:.1f} us against "
              f"{nb} single K3 launches {ms['single'] * 1e3:.1f} us; one "
              f"batched launch no slower: {ms['K9'] <= ms['single']}; bound "
              f"{bnd[0] * 1e3:.1f} us ({nbytes / 1e6:.1f} MB: {nb} x K3's "
              f"bytes, the tables once), {bnd[0] / ms['K9']:.3f} of it",
              flush=True)
        if k9 is None:
            k9 = {"ms": ms["K9"], "plain_ms": ms["plain"], "bound": bnd,
                  "library_ms": ms["library"]}
        del A, Pt, y, P, kp, ks, runs
        torch.cuda.empty_cache()
    del a, viol, mask, geom
    torch.cuda.empty_cache()

    # (b) hog1p_5d_sens, the path
    hs = pt.models.hog1p_5d_sens()
    s = pt.SensFspSolverMultiSinks(odes_type="auto", device=dev)
    s.set_model(hs.model)
    s.set_constraint_functions(hs.constraint)
    s.set_initial_bounds(hs.bounds)
    s.set_expansion_factors(hs.expansion_factors)
    s.set_initial_distribution(hs.x0, hs.p0)
    actions = [0]
    action = SensOperator.action

    def counted(self, t, y):
        actions[0] += 1
        return action(self, t, y)
    SensOperator.action = counted
    try:
        d9, launch9, wall9 = run_solve(
            9, f"hog1p_5d_sens t={HOG_T_FINAL:g} tol={HOG_TOL:g}", s,
            HOG_T_FINAL, HOG_TOL, mass_tol)
    finally:
        SensOperator.action = action
    check(isinstance(s._ode_solver, pt.BdfSolver),
          "hog1p_5d_sens did not run the BDF integrator")
    sop = s._operator
    subs = [o for o in sop.cxdA if o is not None]
    per = 1 + len(subs)
    for i, op in enumerate(sop.sub_ops()):
        check(op.synth_mask, f"hog1p_5d_sens operator {i}: not on K3")
        tables(9, f"hog1p_5d_sens final operator {i} (reactions "
                  f"{op.enable_reactions})", op)
    rhs = s.get_event_log().events["RHSEvaluation"].count
    print(f"[9b] {actions[0]} sensitivity actions, {rhs} RHS evaluations "
          f"(GMRES's residual matvecs are not counted as RHS evaluations); "
          f"per action {launch9['batched_synth'] / actions[0]:.3f} batched "
          f"launch and {launch9['synth'] / actions[0]:.3f} K3 launches "
          f"(expected 1 and {per}); per RHS evaluation "
          f"{sum(launch9.values()) / rhs:.3f} launches", flush=True)
    check(launch9["batched_synth"] == actions[0]
          and launch9["synth"] == per * actions[0]
          and launch9["mask"] + launch9["batched_mask"] == 0,
          f"hog1p_5d_sens: {launch9} for {actions[0]} actions")
    check(d9.dp.shape == (2, d9.num_states) and np.isfinite(d9.dp).all(),
          "hog1p_5d_sens: dp not finite or of the wrong shape")
    l1 = l1_by_state(d9, d5)
    print(f"[9b] L1 of p to phase 5's distribution {l1:.3e} (limit "
          f"{2 * HOG_TOL:g}); {d9.num_states} states against "
          f"{d5.num_states}; wall {wall9:.2f} s; sum(dp) "
          f"{d9.dp.sum(axis=1).tolist()}", flush=True)
    check(l1 <= 2 * HOG_TOL, f"hog1p_5d_sens: L1 to phase 5 {l1:.3e}")
    fim = d9.compute_fim()
    fmax = float(np.abs(fim).max())
    asym = float(np.abs(fim - fim.T).max()) / max(fmax, 1e-300)
    eig = np.linalg.eigvalsh(0.5 * (fim + fim.T))
    print(f"[9b] FIM {fim.tolist()}, relative asymmetry {asym:.3e}, "
          f"eigenvalues {eig.tolist()}", flush=True)
    check(np.isfinite(fim).all(), "hog1p_5d_sens: non-finite FIM")
    check(asym <= 1e-12, f"hog1p_5d_sens: FIM asymmetry {asym:.3e}")
    check(eig.min() >= -1e-10 * eig.max(),
          f"hog1p_5d_sens: FIM eigenvalues {eig.tolist()}")

    # (a) on the final operator and the solve's own sensitivities
    op = sop.base
    nf = op.geom.n
    P = s._y.p.view(3, nf)[1:].clone()
    del s, sop, subs
    torch.cuda.empty_cache()
    c = op.coefficients(HOG_T_FINAL)
    hb = op.data().bounds
    label = f"hog1p_5d_sens final {op.shape}"
    check_batched(label, c, P, op.props, op.geom, bounds=hb)
    fviol = bo.violation_bits(op.space.constraints, op.stoichiometry,
                              op.shape, dev)
    check_batched(label, c, P, op.props, op.geom, mask=op.space.mask_bytes(),
                  viol=fviol)
    del fviol
    runs = {"plain": lambda: bk.box_action_synth_batched_reference(
                c, P, op.props, hb, op.geom),
            "single": lambda: [bk.box_action_synth(c, P[i], op.props, hb,
                                                   op.geom)
                               for i in range(2)],
            "K9": lambda: bk.box_action_synth_batched(c, P, op.props, hb,
                                                      op.geom)}
    timed(f"{label} nb=2 per call: K9 (K3), 2 single K3 launches, plain",
          runs, ["plain", "single", "K9", "K9", "single", "plain"],
          {"plain": 3, "single": 20, "K9": 20})
    del P, op, runs
    torch.cuda.empty_cache()

    # (c) the reference package's oracle
    rel, nst, wall = fd_trans_oracle(dev, FD_T_FINAL, FD_TOL, FD_RTOL,
                                     FD_ATOL, FD_EPS)
    print(f"[9c] hog1p_5d_sens t={FD_T_FINAL:g} tol={FD_TOL:g} (ODE "
          f"{FD_RTOL:g}, {FD_ATOL:g}): {nst} states, {wall:.2f} s; "
          f"dP/d(trans) against the central difference of two hog1p_5d "
          f"solves at trans = 0.01 +/- {FD_EPS:g}: relative L1 {rel:.3e} "
          f"(limit {FD_LIMIT:g})", flush=True)
    check(rel < FD_LIMIT, f"hog1p_5d_sens finite-difference oracle: "
                          f"relative L1 {rel:.3e}")
    return launch9, k9


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
    for line in ptxas_lines(bk.KERNEL.build_log):
        print(f"[1] ptxas, box kernel {line}", flush=True)

    # ---------------------------------------------------------- phase 2
    rng = np.random.default_rng(1234)
    max_err = {"mask": 0.0, "synth": 0.0, "sharded": 0.0, "batched": 0.0}
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
        k1 = check_mask(phase, label, c, p, mask, op.props, viol, op.geom)
        if op.synth_mask:
            check_synth(phase, label, c, p, op.props, op.data().bounds,
                        op.geom, k1)

    def tables(phase, label, op, field_rows=()):
        """Checks and prints how ``op`` holds its propensities: the
        reactions ``field_rows`` on field rows, every other on a table."""
        pp = op.props
        rows = tuple(r for r, ax in enumerate(pp.axis) if ax == bk.FIELD_ROW)
        print(f"[{phase}] {label}: propensity table axes {pp.axis} "
              f"({bk.FIELD_ROW}: field row, {bk.CONST_AXIS}: constant), "
              f"{pp.table_bytes()} B of tables, {pp.field_bytes()} B of "
              f"field rows (a field per reaction would be "
              f"{8 * pp.num_reactions * pp.n} B); [R, n] fields held: "
              f"{op._prop_fields is not None}", flush=True)
        check(rows == tuple(field_rows),
              f"{label}: field rows {rows}, expected {tuple(field_rows)}")
        check(op._prop_fields is None,
              f"{label}: the operator holds [R, n] propensity fields")

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
    host_op = None
    for name, bundle, bounds, ts in cases:
        op = operator(bundle, np.asarray(bounds))
        tables(2, name, op, (4, 6) if name == "transcr_reg_6d" else ())
        if name == "hog1p_5d":
            host_op = op
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
    a = bo.propensity_tables(rep.model, shape, dev)
    check(a.num_field_rows == 0, "128^3: a reaction is not on a table")
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
        A = generator_csr(c, mask, a.dense(), viol, shape,
                          rep.model.stoichiometry, nc)
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
    tb = a.table_bytes()
    roof_bytes = {"K1": pr.box_action_bytes(n, n, R, False, table_bytes=tb),
                  "K3": pr.box_action_bytes(n, n, R, True, table_bytes=tb)}
    for k, v in roof_bytes.items():
        old = pr.field_box_action_bytes(n, n, R, k == "K3")
        print(f"[2] {k} at {BENCH_EDGE}^3: {v / n:.2f} B/element "
              f"({v / 1e6:.1f} MB, bound {bound(v, flops)[0] * 1e3:.1f} us); "
              f"the field-reading kernel's model {old / n:.0f} B/element "
              f"({bound(old, flops)[0] * 1e3:.1f} us)", flush=True)
    print(f"[2] {BENCH_EDGE}^3: K3 {ms['K3'] * 1e3:.1f} us, K1 "
          f"{ms['K1'] * 1e3:.1f} us; K3 no slower than K1: "
          f"{ms['K3'] <= ms['K1']}", flush=True)

    def host_us(fn, calls=1000):
        """Host microseconds per call of ``fn`` over ``calls`` calls
        without a synchronisation (on a box small enough that the device
        keeps up)."""
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(calls):
            fn()
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        return (t2 - t1) * 1e6 / calls

    hmask, hviol = k1_data(host_op)
    hp = torch.where(hmask != 0, torch.ones((), device=dev, dtype=torch.float64),
                     torch.zeros((), device=dev, dtype=torch.float64))
    hc = host_op.model.coefficients(60.0)
    host = {"K1": host_us(lambda: bk.box_action(
                hc, hp, hmask, host_op.props, hviol, host_op.geom)),
            "K3": host_us(lambda: bk.box_action_synth(
                hc, hp, host_op.props, host_op.data().bounds,
                host_op.geom))}
    print(f"[2] host time per launch (hog1p_5d box {host_op.shape}, 1000 "
          f"calls without a synchronisation): K1 {host['K1']:.1f} us, K3 "
          f"{host['K3']:.1f} us", flush=True)
    # What a K3 launch's host time is made of.  The bare C launch writes
    # into the outputs of the wrapper call kept in ``keep``.
    import ctypes
    hg, hb = host_op.geom, host_op.data().bounds
    keep = bk.box_action_synth(hc, hp, host_op.props, hb, hg)
    lib, hprm = bk.KERNEL.load(), hg.params(hc, hb, host_op.props)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    narrow, tiny = int(hg.narrow(hb)), torch.zeros(16, device=dev)
    parts = {
        "the C launch through ctypes": lambda: lib.box_action_launch(
            ctypes.byref(hprm), ctypes.byref(hg._ptrs), hg.nblocks, 1,
            narrow, dev.index, stream),
        "a trivial ctypes call": lib.box_action_threads,
        "one tiny PyTorch kernel": lambda: tiny.add_(1.0),
        "torch.empty": lambda: torch.empty(hg.n_out + hg.nc,
                                           dtype=torch.float64, device=dev),
        "BoxGeometry.params": lambda: hg.params(hc, hb, host_op.props),
        "model.coefficients(t)": lambda: host_op.model.coefficients(60.0)}
    print(f"[2] host time of a K3 launch's parts (us per call, parameter "
          f"struct {ctypes.sizeof(hprm)} B): " + ", ".join(
              f"{k} {host_us(f):.2f}" for k, f in parts.items()), flush=True)
    del k1, run, keep
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
    tables(4, "repressilator final operator", s._operator)
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
    tables(5, "hog1p_5d final operator", s._operator)
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
    tables(6, "transcr_reg_6d final operator", s._operator, (4, 6))
    final_operator(6, "transcr_reg_6d", s, TR6_T_FINAL, synth=False)
    # K1 where the rows of the last axis are short and two reactions read
    # field rows
    op6 = s._operator
    m6, v6 = k1_data(op6)
    c6 = op6.model.coefficients(TR6_T_FINAL)
    t6 = {k: [] for k in ("K1", "plain")}
    for k in ("plain", "K1", "K1", "plain"):
        fn = bk.box_action if k == "K1" else bk.box_action_reference
        t6[k].append(time_ms(lambda: fn(c6, s._y.p, m6, op6.props, v6,
                                        op6.geom), reps=20))
    print(f"[6] K1 on the final operator {op6.shape} (rows of "
          f"{op6.shape[-1]}): " + ", ".join(
              f"{k} " + " / ".join(f"{v * 1e3:.1f}" for v in vs)
              for k, vs in t6.items()) + f" us; {smi}", flush=True)
    del s, op6, m6, v6
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 7
    from pacmensl_tpu_torch.parallel.halo_box import halo_width, window_rows

    def slab_windows(geom, p, mask, a, viol):
        """``geom``'s box cut into SLABS axis-0 slabs, each window holding
        its neighbours' halo planes as the exchange delivers them: a list
        of (K4 geometry, p, mask, propensities, violation bits)."""
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
            out.append((g, win(p), win(mask), a.window(o, rows),
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

    def library_k4(label, c, p, mask, a, viol, geom, windows, k4, reps=100):
        """One torch.mv per slab of the generator's CSR rows of that slab
        (the function of one K4 launch), each checked against the slab's
        K4 (dp, sinks) in ``k4``; ms per slab and per sweep."""
        plane = geom.plane
        per = []
        for w, (kp, ks) in zip(windows, k4):
            g = w[0]
            lo = (g.origin0 + g.out_lo) * plane
            A = generator_csr(c, mask, a.dense(), viol, geom.shape,
                              geom.stoich, geom.nc, (lo, lo + g.n_out))
            y = torch.mv(A, p)
            scale = float(kp.abs().max())
            err = max(float((y[:g.n_out] - kp).abs().max()),
                      float((y[g.n_out:] - ks).abs().max()))
            check(err <= 1e-9 * scale, f"{label}: a slab's CSR rows differ "
                                       f"from K4 by {err:.3e}")
            per.append(min(time_ms(lambda: torch.mv(A, p), reps)
                           for _ in range(2)))
            del A, y
        print(f"[7a] {label} library: torch.mv of each slab's CSR rows "
              + " / ".join(f"{t * 1e3:.1f}" for t in per)
              + f" us, a sweep {sum(per) * 1e3:.1f} us", flush=True)
        return sum(per)

    # 7a: the 128^3 box of phase 2
    win128 = slab_windows(geom, p, mask, a, viol)
    check_k4(f"{BENCH_EDGE}^3 box", c, p, mask, a, viol, bench_bounds, geom,
             win128)
    ms4 = time_k4(f"{BENCH_EDGE}^3 box", c, p, mask, a, viol, bench_bounds,
                  geom, win128, with_plain=True)
    lib4_ms = library_k4(f"{BENCH_EDGE}^3 box", c, p, mask, a, viol, geom,
                         win128, [k4_launch("synth", c, bench_bounds, w)
                                  for w in win128])
    # p is read at the valid elements of the rows that the slab's rows and
    # their sources span (one span each: the windows have no gap)
    roof_bytes["K4"] = sum(
        pr.box_action_bytes(w[0].n, w[0].n_out, R, True, n_valid=sum(
            int((w[2][a * w[0].plane:b * w[0].plane] != 0).sum())
            for a, b in w[0].read_spans), table_bytes=tb)
        for w in win128)
    bounds_ms = {k: bound(v, flops) for k, v in roof_bytes.items()}
    print(f"[7a] K4 sweep at {BENCH_EDGE}^3: {roof_bytes['K4'] / 1e6:.1f} MB, "
          f"bound {bounds_ms['K4'][0] * 1e3:.1f} us", flush=True)
    hw = slab_windows(host_op.geom, hp, hmask, host_op.props, hviol)
    hb = host_op.data().bounds
    host["K4"] = host_us(lambda: k4_launch("synth", hc, hb, hw[1]))
    host["K4 mask"] = host_us(lambda: k4_launch("mask", hc, hb, hw[1]))
    print(f"[7a] host time per K4 launch (a slab of the hog1p_5d box "
          f"{host_op.shape}): synthesized {host['K4']:.1f} us, mask-reading "
          f"{host['K4 mask']:.1f} us", flush=True)
    del hw
    del win128, a, viol, mask, p, geom
    torch.cuda.empty_cache()
    # 7a: the repressilator's final operator and solution of phase 4
    mask4, viol4 = k1_data(op4)
    c4 = op4.model.coefficients(SLICE_T_FINAL)
    b4 = op4.data().bounds
    win4 = slab_windows(op4.geom, p4, mask4, op4.props, viol4)
    k1_4 = check_k4(f"repressilator final {op4.shape}", c4, p4, mask4,
                    op4.props, viol4, b4, op4.geom, win4)
    ms4f = time_k4(f"repressilator final {op4.shape}", c4, p4, mask4,
                   op4.props, viol4, b4, op4.geom, win4, with_plain=False)
    print(f"[7a] repressilator final {op4.shape}: K3 {ms4f['K3'] * 1e3:.1f} "
          f"us, K1 {ms4f['K1'] * 1e3:.1f} us; K3 no slower than K1: "
          f"{ms4f['K3'] <= ms4f['K1']}", flush=True)
    library("7a", c4, p4, mask4, op4.props, viol4, op4.shape,
            op4.geom.nc, k1_4, reps=10)
    del win4, k1_4, mask4, viol4, op4, p4
    torch.cuda.empty_cache()

    def rank_checks(phase, label, res, tol, per_matvec):
        """The checks of a sharded solve's ranks: every matvec on K4 with
        ``per_matvec`` box launches, the same steps and sinks on every
        rank, and phase 4's output checks on the distribution; returns the
        distribution and K4 launches."""
        d = res[0]
        launches = sum(r["launches"]["sharded_mask"]
                       + r["launches"]["sharded_synth"] for r in res)
        for r in res:
            k4 = r["launches"]["sharded_mask"] + r["launches"]["sharded_synth"]
            print(f"[{phase}] rank {r['rank']}: {r['matvecs']} matvecs, "
                  f"{k4} box launches, {k4 / max(r['matvecs'], 1):.3f} per "
                  f"matvec (expected {per_matvec}), no sink-reduce launch",
                  flush=True)
            check(k4 == per_matvec * r["matvecs"],
                  f"{label}: rank {r['rank']} made {k4} box launches for "
                  f"{r['matvecs']} matvecs, not {per_matvec} each")
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
        run_ranks(world, "nccl", SLICE_T_FINAL, SLICE_TOL), SLICE_TOL,
        1 if world == 1 else 2)
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
        SLICE_TOL, 2)
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

    # ---------------------------------------------------------- phase 9
    launch9, k9 = sens_phase(dev, smi, d5, bdf_mass_tol, run_solve, tables,
                             same_twice, max_err)

    paths = (launch4, launch5, launch6, launch9)
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
         "library_ms": lib4_ms},
        {"name": "box_action_batched", "route": "cuda",
         "source": "pacmensl_tpu_torch/csrc/box_action.cu",
         "replaces": "pacmensl_tpu/ops/sens_operator.py:151",
         "launches": launch9["batched_synth"] + launch9["batched_mask"],
         "max_abs_err": max_err["batched"],
         "ms": k9["ms"], "plain_ms": k9["plain_ms"],
         "bound_ms": k9["bound"][0], "bound_by": k9["bound"][1],
         "library_ms": k9["library_ms"]}] + probe_entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
