#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pacmensl_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases (each check that fails ends the run with a nonzero exit):

1. Device: the card's name and power limit from ``nvidia-smi``; build (or
   load) the box kernel from ``pacmensl_tpu_torch/csrc`` and print the
   build time.
2. Kernel vs its plain PyTorch version, in float64, on the box shapes of
   the bundled models at small bounds (hog1p_3d at t = 0, 30, 120), after
   an epoch-style bounds change at fixed capacity, and on the fixed-bounds
   128^3 repressilator box, where both are timed with CUDA events.  In
   every case ``dp`` is bitwise equal to the plain version's, the sinks
   (summed in another order) agree within rtol 1e-12 / atol 1e-13, and two
   launches give bitwise-equal ``dp`` and sinks.
3. Poisson oracle: the transient solve of ``models.poisson()`` to t = 10
   on the GPU against the Poisson(2t) pmf.
4. The slice: repressilator with its custom constraints, t = 10,
   fsp_tol = 1e-4, Krylov, float64, with the box kernel's launch count.
   Then the kernel against its plain version on the slice's final
   operator (its capacity, bounds, mask and constraints) and solution, and
   the same solve with the plain version in place of the kernel: the two
   distributions must lie within 2 * fsp_tol in L1.

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
    t0 = time.perf_counter()
    bk.KERNEL.load()
    print(f"[1] box kernel: built in {bk.KERNEL.build_seconds:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s) -> "
          f"{bk.KERNEL.path.name}", flush=True)
    if bk.KERNEL.build_log:
        print(bk.KERNEL.build_log, file=sys.stderr, flush=True)

    # ---------------------------------------------------------- phase 2
    rng = np.random.default_rng(1234)
    max_err = 0.0

    def check_action(phase, label, c, p, mask, a, viol, geom):
        """Kernel (launched twice) against the plain version."""
        nonlocal max_err
        kp, ks = bk.box_action(c, p, mask, a, viol, geom)
        kp2, ks2 = bk.box_action(c, p, mask, a, viol, geom)
        rp, rs = bk.box_action_reference(c, p, mask, a, viol, geom)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(kp).all() and torch.isfinite(ks).all()),
              f"{label}: non-finite kernel output")
        err = float(max((kp - rp).abs().max(),
                        (ks - rs).abs().max() if ks.numel() else 0.0))
        check(torch.allclose(kp, rp, rtol=1e-12, atol=1e-13),
              f"{label}: dp differs, max abs {err:.3e}")
        check(torch.equal(kp, rp),
              f"{label}: dp is not bitwise the plain version's")
        check(torch.allclose(ks, rs, rtol=1e-12, atol=1e-13),
              f"{label}: sinks differ, max abs {err:.3e}")
        check(torch.equal(kp, kp2) and torch.equal(ks, ks2),
              f"{label}: two launches differ")
        max_err = max(max_err, err)
        print(f"[{phase}] {label:<34} shape={geom.shape} n={geom.n} "
              f"max_abs_err={err:.3e}", flush=True)

    def compare(phase, label, op, t, p=None):
        d = op.data()
        if p is None:
            p = torch.as_tensor(rng.random(op.geom.n), device=dev)
            p = torch.where(d.mask != 0, p,
                            torch.zeros((), device=dev, dtype=p.dtype))
        check_action(phase, label, op.model.coefficients(t), p, d.mask,
                     op.prop_fields, d.viol, op.geom)

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
    compare(2, "toggle, bounds grown in capacity", op, 0.0)

    # the fixed-bounds 128^3 repressilator box (all states valid)
    rep = m.repressilator()
    shape = (BENCH_EDGE,) * 3
    n = int(np.prod(shape))
    cs = pt.ConstraintSet(None, [BENCH_EDGE - 1] * 3, None, 3)
    geom = bk.BoxGeometry(shape, rep.model.stoichiometry, 3)
    a = bo.propensity_fields(rep.model, shape, dev)
    viol = bo.violation_bits(cs, rep.model.stoichiometry, shape, dev)
    mask = torch.ones(n, dtype=torch.uint8, device=dev)
    p = torch.as_tensor(rng.random(n), device=dev)
    c = rep.model.coefficients(0.0)
    check_action(2, f"{BENCH_EDGE}^3 repressilator box", c, p, mask, a,
                 viol, geom)

    def time_ms(fn, reps=100):
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

    plain_ms = time_ms(lambda: bk.box_action_reference(c, p, mask, a, viol,
                                                       geom))
    kern_ms = time_ms(lambda: bk.box_action(c, p, mask, a, viol, geom))
    kern_ms2 = time_ms(lambda: bk.box_action(c, p, mask, a, viol, geom))
    plain_ms2 = time_ms(lambda: bk.box_action_reference(c, p, mask, a, viol,
                                                        geom))
    print(f"[2] {BENCH_EDGE}^3 repressilator box per matvec: kernel "
          f"{kern_ms * 1e3:.1f} / {kern_ms2 * 1e3:.1f} us, plain "
          f"{plain_ms * 1e3:.1f} / {plain_ms2 * 1e3:.1f} us "
          f"(100 calls each, order plain-kernel-kernel-plain; {smi})",
          flush=True)
    del a, viol, mask, p
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

    # ---------------------------------------------------------- phase 4
    def slice_solver():
        s = pt.FspSolverMultiSinks(backend="box", odes_type="krylov",
                                   device=dev)
        s.set_model(rep.model)
        s.set_constraint_functions(rep.constraint)
        s.set_initial_bounds(rep.bounds)
        s.set_expansion_factors(rep.expansion_factors)
        s.set_initial_distribution(rep.x0, rep.p0)
        return s

    s = slice_solver()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    bk.KERNEL.reset_counts()
    t0 = time.perf_counter()
    d = s.solve(SLICE_T_FINAL, SLICE_TOL)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = bk.KERNEL.launches, bk.KERNEL.plain_cuda_calls
    peak = torch.cuda.max_memory_allocated(dev)
    ev = s.get_event_log().events
    mass, sinks = d.sum(), np.asarray(d.sinks)
    print(f"[4] repressilator t={SLICE_T_FINAL:g} tol={SLICE_TOL:g}: "
          f"{d.num_states} states (reference CPU f64: {SLICE_STATES}), "
          f"bounds {d.bounds.tolist()}, capacity {tuple(s._space.shape)}, "
          f"epochs {ev['ODESolve'].count}, RHS evaluations "
          f"{ev['RHSEvaluation'].count}, wall {wall:.2f} s, peak device "
          f"memory {peak / 2**30:.2f} GiB, sum(p) {mass:.10f}, sum(sinks) "
          f"{sinks.sum():.3e}, kernel launches {launches}, plain calls on "
          f"CUDA {plain_calls}", flush=True)
    print(s.get_event_log().report(), flush=True)
    check(np.isfinite(d.p).all() and np.isfinite(sinks).all(),
          "non-finite solution")
    check(d.p.min() > -1e-12, f"negative probability {d.p.min():.3e}")
    check(mass >= 1.0 - SLICE_TOL, f"sum(p) = {mass} < 1 - {SLICE_TOL:g}")
    # Sinks count a transition in every constraint it violates, so
    # max(sinks) <= mass that left <= sum(sinks): mass is conserved iff
    # sum(p) + max(sinks) <= 1 <= sum(p) + sum(sinks), to rounding.
    check(mass + sinks.sum() >= 1.0 - 1.0e-8,
          f"sum(p) + sum(sinks) - 1 = {mass + sinks.sum() - 1:.3e}")
    check(mass + sinks.max() <= 1.0 + 1.0e-8,
          f"sum(p) + max(sinks) - 1 = {mass + sinks.max() - 1:.3e}")
    check(launches > 0, "the solve launched no box kernel")
    check(plain_calls == 0, f"the solve ran the plain version "
                            f"{plain_calls} times on CUDA")

    # the kernel against its plain version at the slice's own capacity,
    # bounds, mask and constraints, on the final solution
    compare(4, "slice: final operator and p", s._operator,
            SLICE_T_FINAL, p=s._y.p)
    del s
    torch.cuda.empty_cache()

    # The same solve with the plain version in place of the kernel.  Its
    # dp is bitwise the kernel's but its sinks are summed in another
    # order, and the sinks enter the Krylov norms and the stop-check, so
    # the two solves may take different expansion paths (PERF.md).  Both
    # are certified to SLICE_TOL, so they must agree within 2 * SLICE_TOL.
    bo.box_action = bk.box_action_reference
    t0 = time.perf_counter()
    sp = slice_solver()
    dplain = sp.solve(SLICE_T_FINAL, SLICE_TOL)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    bo.box_action = bk.box_action
    evp = sp.get_event_log().events
    del sp
    torch.cuda.empty_cache()
    l1 = l1_by_state(d, dplain)
    print(f"[4] the same solve with the plain version: {dplain.num_states} "
          f"states, epochs {evp['ODESolve'].count}, RHS evaluations "
          f"{evp['RHSEvaluation'].count}, wall {wall_plain:.2f} s; L1 to "
          f"the kernel's solution {l1:.3e} (limit {2 * SLICE_TOL:g})",
          flush=True)
    check(l1 <= 2 * SLICE_TOL, f"L1 between the kernel's and the plain "
                               f"version's solve {l1:.3e} > "
                               f"{2 * SLICE_TOL:g}")
    # The state count is a discrete outcome that rounding selects (each
    # expansion step adds thousands of states), so a change of summation
    # order alone can move it by several percent; the L1 check above is
    # the one on the distribution.
    check(abs(d.num_states - SLICE_STATES) <= 0.05 * SLICE_STATES,
          f"{d.num_states} states, not within 5% of {SLICE_STATES}")

    print(json.dumps({"kernels": [{
        "name": "box_action", "route": "cuda",
        "source": "pacmensl_tpu_torch/csrc/box_action.cu",
        "replaces": "pacmensl_tpu/ops/pallas_box.py:655",
        "launches": launches, "max_abs_err": max_err,
        "ms": kern_ms, "plain_ms": plain_ms}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
