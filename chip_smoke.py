#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pacmensl_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases (each check that fails ends the run with a nonzero exit):

1. Device: the card's name and power limit from ``nvidia-smi``; build (or
   load) every library from ``pacmensl_tpu_torch/csrc``, one ``nvcc``
   each, all at once: the box kernel, the probes, the box kernel's two
   ablation builds (phase 14) and the fused BDF step's passes (phase 15);
   print the build times and each production
   box instantiation's registers, static shared memory and spills
   (``ptxas``).
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
   synchronisation, on the small hog1p_5d box) and of a K3 launch's parts
   (``tools/base_probe.py``'s host side) and the new compulsory bytes
   beside the field-reading kernel's model.
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
      per sweep of the 4 slabs beside K1 and K3, and against the library
      yardstick (the port never calls it), per slab and per sweep in two
      readings: one ``torch.mv`` of each slab's rows of the same
      generator as a CSR matrix with the slab's sink rows appended, and
      one of its state rows with the sinks as a separate dense reduction
      (a sink row holds every state with a transition out of the
      constraints: one long row in the first reading).  The same two
      readings wherever the library is timed below.
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
   box launch (also with halos), sinks reduced in the launch.
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
      sensitivities; a warp applies a unit's reactions to a chunk of up
      to 4 vectors) in both modes at the 128^3 box with nb = 2, 3 and 4,
      and on hog1p_5d_sens's final operator with the solve's own vectors
      (p and both sensitivities, nb = 3, the solve's batch; the two
      sensitivities, nb = 2): dp bitwise its plain version's and nb
      single launches', sinks bitwise the single launches' and within
      1e-12 of the plain version's (relative to each vector's largest),
      two launches bitwise equal.  Timed with CUDA events beside nb
      single K3 launches (also per vector) and the plain version; at
      128^3 and at the final operator also beside ``torch.sparse.mm`` of
      the generator as CSR with the ``[n, nb]`` block (both readings).
   b. hog1p_5d_sens with its custom constraints, t = 180, fsp_tol =
      1e-4, ``"auto"`` -> BDF, every operator on K3 and on tables:
      phase 5's output checks, its Arnoldi iterations replayed from
      CUDA graphs, per action (replayed ones included) one K9 (p and the
      two sensitivities) and two K3 launches (the derivative operators),
      27,440,236 states after 7,507 RHS evaluations, finite ``dp``, L1
      of p to phase 5's distribution <= 2 * fsp_tol, and the FIM finite,
      symmetric to 1e-12 relative, its eigenvalues >= -1e-10 times the
      largest.
   c. The reference package's oracle (tests/test_sensfsp.py:225-277):
      hog1p_5d_sens to t = 3 at fsp_tol 1e-6 and ODE tolerances (1e-9,
      1e-14), dP/d(trans) against a central difference of two hog1p_5d
      solves at trans = 0.01 +/- 0.001: relative L1 below 5e-2.

10. The compressed (ELL) backend and the stationary solver:

   a. The repressilator of phase 4 on ``backend="ell"`` from the start
      (plain PyTorch gathers on the card, no kernel launch): phase 4's
      output checks, L1 <= 2 * fsp_tol to phase 4's distribution (the
      state counts may differ), its ``EventLog`` phases and its assembly
      time per epoch.
   b. Its action at the final state set against one ``torch.mv`` of the
      same generator as CSR with the sink rows appended (dp and sinks
      within 1e-12 relative), timed with CUDA events over 100 actions
      beside K3 on phase 4's final box, the CSR product and the action on
      the same set in GRAPH's (reverse Cuthill-McKee) order; the fill
      floor (K3's time per box element over ELL's per state) and the
      "auto" rule for custom constraints that follows from it.
   c. The repressilator to t = 2 on ``backend="box"`` with
      ``PACMENSL_BOX_MEM_BUDGET`` = ``MIGRATE_BUDGET``: it migrates to ELL
      partway (K3 until then), L1 <= 2 * fsp_tol to phase 7c's box-only
      solve; K1 and K3 against their plain versions on the operator and
      solution of the last box epoch.
   d. hog1p_5d_sens at phase 9c's setting on ELL and on the box, under
      BDF (the setting's) and under Krylov: p within 1e-6 relative L1
      under both; each sensitivity within 1e-6 under Krylov and within
      ``SENS_BDF_LIMIT`` under BDF, whose error norm averages over the
      vector's entries (the box's capacity, ELL's padded list) so the
      two take other steps; the FIM finite and symmetric.
   e. The stationary law: birth-death on both backends against
      Poisson(10) (L1 < 1e-6), then the repressilator (BASELINE.json
      config 5, whose script leaves the backend to ``"auto"``: the box
      with K3, then ELL once the fill falls below the fill floor) at
      ``STAT_TOL``: every round's GMRES converges, sum(pi) = 1 within
      1e-12, pi >= -1e-12, every sink at most ``STAT_TOL``, past the
      96,142 states where the TPU's float32 solve stopped; K1 and K3
      against their plain versions on the last box operator and pi.

11. The pluggable TS methods, the compressed backend over ranks and the
    sensitivity solve over ranks:

   a. The repressilator of phase 4 under ``-fsp_odes_type petsc``
      (``set_from_options``; Dormand-Prince RK, every stage on K3):
      phase 4's output checks (p >= -k atol after k steps, not -1e-12:
      RK's error control holds an entry near 0 to about atol a step), L1
      <= 2 * fsp_tol to phase 4's distribution; steps, rejections, FSP
      retries, RHS evaluations, K3 launches and wall.
   b. The same under ``-ts_type cn`` (CN, two GMRES solves a step),
      reduced to t = 0.02 (``CN_T_FINAL``): L1 <= 2 * fsp_tol to a
      one-device Krylov solve to the same time.
   c. The repressilator on ``backend="ell"`` over one NCCL rank per card
      at t = 10 (L1 <= 2 * fsp_tol to 10a), and over two gloo ranks on
      the card to t = 2 (against phase 7c's one-device solve, the state
      count within 5%): every rank takes the same steps and holds the same
      state set (count and checksum); the values crossing ranks per
      matvec beside n_pad.
   d. The batched launch on a window (K9w) at the 128^3 box cut into 4
      slabs (nb = 2, 3, 4; both modes), in one launch a slab; at the end
      of phase 9a on hog1p_5d_sens's final operator cut into 2 and 4
      slabs, and in 11e on the final box of 9c's cut in 2 slabs (nb = 3,
      K3 mode).  dp bitwise the plain version's and nb single K4
      launches', sinks bitwise the K4 launches' and within 1e-12 of the
      plain version's.  The slabs' dp bitwise the whole box's K9.  Timed
      with CUDA events beside nb K4 sweeps, the unsharded K9, the plain
      version, one ``torch.sparse.mm`` of each slab's CSR state rows with
      the sinks' dense reduction, and the sweep's time before the
      one-pass tail (``K9W_BEFORE_US``).
   e. hog1p_5d_sens at phase 9c's setting under Krylov over two gloo
      ranks on the box (K9w and K4, the derivative operators on K9w's
      halos) and on ELL: the one-device solve's states, p and dp within
      1e-10 relative of it; per sensitivity action on each rank the
      mesh's halo exchanges and all-reduces (one each on the box) and
      the K9w and K4 launches.

12. The box's axis order (``statespace/permute.py``: every box solve above
    lays its species axes out by descending extent, as the reference
    package does, and rebuilds in a new order where a capacity outgrowth
    finds it stale) and eager capacity (``preallocate``):

   a. Each box solve prints its axis orders at set-up and at every
      reordered rebuild, and the count and time of those rebuilds (the
      ``BoxReorder`` event); phase 12 lists them for phases 4, 5, 6 and
      9b.
   b. hog1p_5d and hog1p_5d_sens from their set-up to their first
      reordered rebuild: every row (p and each s_j) carried bitwise by
      state, the new states 0.
   c. After phases 4, 5 and 6: K3 on the repressilator's and hog1p_5d's
      final capacities and K1 on transcr_reg_6d's, in the box's order
      (the solve's operator and p) and in user order (the parent's
      layout: the same capacity transposed, built at the final bounds,
      p carried by state), each against its plain version, dp bitwise
      by state across the layouts where both hold the same states; CUDA
      events over 100 calls beside the bound.
   d. 11e's box over two ranks: its orders, capacity and halo values per
      matvec and per vector.
   e. hog1p_5d to t = 180 with ``preallocate=True``: phase 5's checks,
      L1 <= 2 * fsp_tol to phase 5's solve on the capacity ladder, and
      both walls.  (hog1p_5d_sens on eager capacity took 1.59x its
      ladder's wall in PERF.md's measurement; it is not rerun here.)

13. The port's entry points (``pacmensl_tpu_torch/examples/``,
    ``pacmensl_tpu_torch/tools/``), called as a user calls them.  Phases
    4, 5, 9b and 10e already run their solves through them (phase 4
    through ``examples.repressilator.run_stage``, 5, 9b and 10e through
    ``tools.bench_configs``' configs; 4, 5 and 9b with the option
    ``-fsp_backend box``, since under ``"auto"`` the fill rule moves the
    repressilator to ELL partway), and 10b times the ELL action with
    ``tools.ell_bench.time_action``.

   a. The repressilator example's stages 2-4 from phase 4's
      distribution (adaptive under the default hyper-rectangle
      constraints from [22, 2, 2], and both fixed stages at the adaptive
      stages' final bounds): phase 4's output checks; the two adaptive
      stages within 2 * fsp_tol in L1; each fixed stage keeps its bounds
      (no expansion) and lies within 2 * fsp_tol of its adaptive stage.
   b. transcr_reg_6d to the example's t = 300 (``examples.
      transcr_reg_6d.main``): K1 on the box until the fill rule moves it
      to ELL; phase 6's output checks; at the migration, K1 against its
      plain version on the last box epoch's operator and p, and K1's
      and the library's times there (both readings); the migration's time and
      state count, the K1 launches before it; the final states and
      bounds beside the TPU's record (context only); the ELL action
      against a CSR ``torch.mv`` of the final set (1e-12); L1 <= 2 *
      fsp_tol to an independent ELL solve from the start, reduced to the
      time of the migration.
   c. The scaling sweep at a 256^3 box over n = 1, 2, 4 ranks up to the
      visible cards (``examples.scaling_sweep.main``, NCCL): on every n
      the assembled box dp bitwise one card's K3 dp and the ELL dp
      within 1e-12 of one card's; µs per matvec, efficiency, values sent
      per matvec.
   d. ``tools.dryrun.entry()`` once on the card (one K3 launch, finite,
      mass-conserving), then ``dryrun_multichip`` over one NCCL rank per
      card.
   e. ``python -m pacmensl_tpu_torch.tools.flagship -repeat 2`` as a
      subprocess: exit 0 and both walls.

14. The box kernel's ablation and fixed-cost probes
    (``python -m pacmensl_tpu_torch.tools.kernel_ablate`` and
    ``tools.base_probe``, through their command lines at their 128^3 box,
    then their functions on phase 4's final repressilator box in both axis
    orders (12c's layouts), phase 5's hog1p_5d box and phase 6's
    transcr_reg_6d box): the kernel with pieces switched off (``r1``,
    ``r2``, ``nosink``, ``unitnosink``, ``full-K1``, and the builds
    without the sinks' tail and without the rows' decode, ``ops/
    ablation.py``), its floor (a zero mask, a box of one row) and the host
    parts of a launch.  Every variant and switch build is checked against
    its plain version before it is timed (a mismatch fails the run); its
    launches are not counted for any path.  The phase's time is printed.

15. The fused passes of a BDF step (``csrc/bdf_step.cu``, ``ops/
    bdf_step.py``: predict, rhs, post, update) against the PyTorch
    operations they replace (``BdfSolver._predict``, ``c a - psi``,
    ``y_pred + d`` with ``_err_norm_dev``'s terms and norm,
    ``_update_D``), bitwise in the int64 views, at q = 1..5 on hog1p_5d's
    final box vector and hog1p_5d_sens's stacked vector (``BDF_SHAPES``);
    a NaN and an Inf in either part of the action or of d set the flags
    as ``vecops.isfinite`` does.  Then each pass timed with CUDA events
    at the stacked vector at q = 3 beside its PyTorch operations and its
    bound (each vector read or written once: q + 3, 3, 4 and 2q + 6 of
    them).  Every solve of phases 4-13 that runs through an entry point
    sets the passes' launch counters to 0 before it and checks after it
    that BDF took them on every attempt: predict, rhs and post once per
    error-norm read (``HostSync.BDFErrorNorm``, equal to
    ``BDFFusedStep``) and update once per accepted step; any other
    integrator launches none.

The ``kernels`` record counts each kernel's launches in the paths' own
solves only: K1 and K3 in phases 4, 5, 6, 9b, 10c (before the
migration), 10e, 11a, 11b, 12e, 13a, 13b (before the migration), 13c
(one card) and 13d (``entry()``), K4 in phases 7b, 7c, 13c and 13d
(over all ranks), K5-K8 in phase 8's two entry points, K9 in phase 9b,
K9w in phase 11e (over both ranks), the fused BDF step's passes in every
solve of phases 4-13 through an entry point (its ``ms``, ``plain_ms`` and
``bound_ms`` are one step's four passes at q = 3, phase 15).
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

from pacmensl_tpu_torch.ops.probes import HBM_RATE
from pacmensl_tpu_torch.tools.timing import (card, graph_ms, k9w_windows,
                                             time_ms)

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
#: phase 11b: CN on the repressilator to this time, reduced from phase
#: 4's t = 10: from the point mass its first-order error estimate against
#: atol 1e-14 takes 10,695 steps by t = 0.02 and 38,295 by t = 1, each two
#: GMRES solves (``python -m pacmensl_tpu_torch.tools.ts_steps --ts cn
#: --backend ell --device cpu --t 0.02 1`` on a host CPU)
CN_T_FINAL = 0.02
#: slabs the box is cut into in phase 7a
SLABS = 4
#: H100 SXM peaks (NVIDIA data sheet): float64 and float32 FLOP/s outside
#: the tensor cores (the memory rate, ``HBM_RATE``, is ``ops/probes.py``'s)
F64_RATE, F32_RATE = 34e12, 67e12
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
#: (3: hog1p_5d_sens's own, p and two sensitivities)
BATCHES = (2, 3, 4)
#: phase 9b: hog1p_5d_sens to t = 180 ends at this state count after this
#: many RHS evaluations; K9 is bitwise single launches, so folding p into
#: the batched launch leaves the solve as it was.  In the reference
#: package's axis order the solve ends one expansion of two bounds past
#: phase 5's 21,467,776 states (in user order: 21,467,776 after 7,482;
#: this script on an H100 80GB HBM3 at 700 W)
SENS_STATES, SENS_RHS = 27440236, 7507
#: phase 9c: the reference package's finite-difference oracle
#: (tests/test_sensfsp.py:225-277): t, fsp_tol, BDF's rtol and atol, the
#: step in trans, and the limit on the relative L1 of dP/d(trans)
FD_T_FINAL, FD_TOL, FD_RTOL, FD_ATOL = 3.0, 1.0e-6, 1.0e-9, 1.0e-14
FD_EPS, FD_LIMIT = 1.0e-3, 5.0e-2
#: phase 11d: K9w's sinks are held to 1e-12 of each vector's largest sink,
#: or of its summed terms where the sinks cancel to less than 1/SINK_CANCEL
#: of them (two summation orders then differ by more than 1e-12 of the sum)
SINK_CANCEL = 1.0e3
#: phase 11d: K9w's sweep (us) at each timed shape before the one-pass
#: tail (commit 8317c44, this script on an H100 80GB HBM3 at 700 W;
#: PERF.md section 6), by (shape, slabs, nb)
K9W_BEFORE_US = {("128^3", 4, 2): "193.6-193.9 us",
                 ("128^3", 4, 3): "219.1-220.4 us",
                 ("128^3", 4, 4): "247.5-248.8 us",
                 ("hog1p_5d_sens final", 2, 3): "3,079.0-3,090.3 us",
                 ("hog1p_5d_sens final", 4, 3): "3,230.1-3,230.8 us"}
#: phase 10c: the vector-memory budget (PACMENSL_BOX_MEM_BUDGET, bytes)
#: under which the repressilator's box solve to t = 2 migrates partway:
#: 504k box elements under Krylov's 62 vectors (the box reaches 94 x 211 x
#: 94 = 1.86M by t = 2)
MIGRATE_BUDGET = 2.5e8
#: phase 10d: the relative L1 within which ELL's and the box's BDF
#: sensitivities at phase 9c's setting agree.  BDF's error norm averages
#: over the vector's entries, so the two backends take other steps (527
#: and 479 RHS evaluations) and their sensitivities differ by BDF's own
#: error: 8.8e-7 and 1.35e-6 on an H100 80GB HBM3 at 700 W (this
#: script), against 3.4e-13 and 8.9e-13 under Krylov
SENS_BDF_LIMIT = 1.0e-5
#: phase 10e: the stationary tolerance, cut from BASELINE.json config 5's
#: 1e-6 (tools/bench_configs.py:96-108), which does not finish in this
#: script's time (PERF.md): 0.08 ends past the TPU's 96,142 states
#: (115,155 states after 44 rounds, this phase on an H100 80GB HBM3 at
#: 700 W) and 0.09 does not (89,468 states, the same solve on the host)
STAT_TOL = 0.08


#: phase 13b: transcr_reg_6d to the example's t_final; the TPU's record
#: of it (the JAX package's float32 run, BASELINE.md:144-160), context only
TR6_EXAMPLE_T = 300.0
TR6_TPU_STATES, TR6_TPU_BOUNDS = 2303250, [82, 124, 6, 2, 10, 36]
#: phase 13c: the scaling sweep's box edge less one (256^3 = 16.8M
#: elements, the scale of the repressilator's final capacity)
SWEEP_BOUND = 255
#: phase 15: the fused BDF step's passes are checked at (box elements,
#: sinks) of hog1p_5d's final box and of hog1p_5d_sens's stacked vector
#: (p and the two sensitivities at its final box), and timed at the
#: second at order BDF_TIMED_Q
BDF_SHAPES = {"hog1p_5d": (94 * 42 * 4 * 42 * 63, 7),
              "hog1p_5d_sens": (3 * 94 * 42 * 4 * 42 * 94, 21)}
BDF_TIMED, BDF_TIMED_Q = "hog1p_5d_sens", 3
#: where the entry points write their CSVs
OUT_DIR = Path(__file__).resolve().parent / "_local" / "smoke"


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


def bound(nbytes, flops, rate=F64_RATE):
    """(bound_ms, bound_by): the least time the card takes to move
    ``nbytes`` and do ``flops`` operations at ``rate`` FLOP/s."""
    tb, tf = nbytes / HBM_RATE, flops / rate
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def same_twice(label, run):
    """Two launches, bitwise equal and finite; returns the first."""
    import torch
    kp, ks = run()
    kp2, ks2 = run()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(kp).all() and torch.isfinite(ks).all()),
          f"{label}: non-finite kernel output")
    check(torch.equal(kp, kp2) and torch.equal(ks, ks2),
          f"{label}: two launches differ")
    return kp, ks


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
    # the columns the rows [lo, hi) and their sinks read
    reach = max(abs(int(np.dot(s, strides.tolist()))) for s in stoich)
    x = x[(x >= lo - reach) & (x < hi + reach)]
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


def split_sinks(A, nc):
    """``A`` of :func:`generator_csr` (``nc`` sink rows last) as ``(rows,
    xs, W)``: the CSR matrix of its state rows, and its sink rows as a
    dense ``[nc, m]`` block over the ``m`` columns ``xs`` that they read,
    so that ``A @ p`` is ``rows @ p`` followed by ``W @ p[xs]``.  A sink
    row holds an entry for every state with a transition out of the
    constraints; in one CSR matrix each is one long row.  The library
    yardstick only."""
    import torch
    k = A.shape[0] - nc
    crow, col, val = A.crow_indices(), A.col_indices(), A.values()
    e = int(crow[k])
    rows = torch.sparse_csr_tensor(crow[:k + 1], col[:e], val[:e],
                                   (k, A.shape[1]))
    srow = torch.repeat_interleave(
        torch.arange(nc, device=val.device), (crow[k + 1:] - crow[k:-1]).long())
    xs, inv = torch.unique(col[e:].long(), return_inverse=True)
    W = torch.zeros((nc, xs.numel()), dtype=val.dtype, device=val.device)
    W.index_put_((srow, inv), val[e:], accumulate=True)
    return rows, xs, W


def split_apply(S, v):
    """``(dp, sinks)`` of :func:`split_sinks`'s ``S`` on ``v`` (``[n]``,
    or ``[n, nb]``: then ``[k, nb]`` and ``[nc, nb]``)."""
    import torch
    rows, xs, W = S
    x = v.index_select(0, xs)
    if v.dim() == 1:
        return torch.mv(rows, v), torch.mv(W, x)
    return torch.sparse.mm(rows, v), W @ x


def library_readings(label, A, nc, v, want, reps=20, warm=5, rounds=2,
                     readings=("csr", "split")):
    """The library yardstick of ``A`` (:func:`generator_csr`) on ``v``
    (``[n]``, or ``[n, nb]``) in two readings: ``"csr"``, one product with
    ``A`` with its sink rows (``torch.mv``, ``torch.sparse.mm``), and
    ``"split"``, the product with its state rows and the sinks as a
    separate dense reduction (:func:`split_sinks`); ``readings``: which.
    Each is checked against the kernel's ``want = (dp,
    sinks)`` (``[nb, k]`` and ``[nb, nc]`` for a block) within 1e-9 of
    dp's largest and timed as the least of ``rounds`` rounds of ``reps``
    calls.  Returns ``{reading: ms}``."""
    import torch
    k = A.shape[0] - nc
    S = split_sinks(A, nc) if "split" in readings else None
    mul = torch.mv if v.dim() == 1 else torch.sparse.mm
    runs = {"csr": lambda: mul(A, v), "split": lambda: split_apply(S, v)}
    out = {}
    for key in readings:
        run = runs[key]
        y = run()
        dp, sk = (y[:k], y[k:]) if key == "csr" else y
        if v.dim() == 2:
            dp, sk = dp.T, sk.T
        err = max(float((dp - want[0]).abs().max()),
                  float((sk - want[1]).abs().max()))
        check(err <= 1e-9 * float(want[0].abs().max()),
              f"{label}: the library's {key} reading differs from the "
              f"kernel by {err:.3e}")
        del y, dp, sk
        out[key] = min(time_ms(run, reps, warm) for _ in range(rounds))
    return out


def readings_text(r):
    """``library_readings``' result as text."""
    names = {"csr": "one CSR product with the sink rows",
             "split": "the state rows' CSR product and the sinks' dense "
                      "reduction"}
    return ", ".join(f"{names[k.split()[0]]}{k[len(k.split()[0]):]} "
                     f"{v * 1e3:.1f} us" for k, v in r.items())


def uncounted(run):
    """``run`` (kernels against their plain versions or the library)
    without adding to the paths' counts; returns what ``run`` returns."""
    from pacmensl_tpu_torch.ops import box_kernel as bk
    counts = (bk.KERNEL.launches, bk.KERNEL.plain_calls,
              bk.KERNEL.plain_cuda_calls)
    held = [dict(d) for d in counts]
    out = run()
    for d, h in zip(counts, held):
        d.update(h)
    return out


def add_launches(*dicts):
    """The launch counts of several runs, summed by mode."""
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def csr_library_ms(label, op, c, p, want, smi, reps=20):
    """The library yardstick on a box operator: ``op``'s generator at
    coefficients ``c`` as CSR on ``p`` in both readings of
    :func:`library_readings`, with 64- and 32-bit indices, checked
    against the kernel's ``want = (dp, sinks)``; the least, ms per call.
    The port never calls it."""
    import torch
    from pacmensl_tpu_torch.ops import box_operator as bo
    mask = op.space.mask.reshape(-1).to(torch.uint8)
    viol = bo.violation_bits(op.space.constraints, op.stoichiometry,
                             op.shape, p.device)
    nc = op.num_constraints
    A = generator_csr(c, mask, op.prop_fields, viol, op.shape,
                      op.stoichiometry, nc)
    # the same matrix with 32-bit indices, the library's other index type
    A32 = torch.sparse_csr_tensor(A.crow_indices().int(),
                                  A.col_indices().int(), A.values(),
                                  A.shape)
    ts = {}
    for key, M in (("int64", A), ("int32", A32)):
        r = library_readings(f"{label} ({key})", M, nc, p, want, reps)
        ts.update({f"{k} ({key} indices)": v for k, v in r.items()})
    print(f"[{label}] library ({A.shape[0]} x {A.shape[1]}, "
          f"{A.values().numel()} nonzeros): " + readings_text(ts)
          + f"; {smi}", flush=True)
    return min(ts.values())


def ptxas_lines(log):
    """One line per box kernel instantiation from ``nvcc -Xptxas -v``'s
    output: its template arguments, registers and spills."""
    import re
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z17box_action_kernelILi"
                      r"(\d+)ELb(\d)E(\w)Lb(\d)ELi(\d+)E", line)
        if m:
            nbv = int(m.group(5))
            name = (f"NCM={m.group(1)} "
                    f"{'synth' if m.group(2) == '1' else 'mask'} "
                    f"F={'int32' if m.group(3) == 'i' else 'int64'} "
                    f"{'grouped' if m.group(4) == '1' else 'one'} rows"
                    f"{f', batched NBV={nbv}' if nbv > 1 else ''}")
            continue
        if name and "spill" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            sm = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {m.group(1)} registers, "
                       f"{sm.group(1) if sm else 0} B static shared "
                       f"memory; {spill}")
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
            one = pt.BoxOperator(s._model_int, s._space)
            want = one.action(t_final, pt.FspVector(p=p_all,
                                                    sinks=s._y.sinks))
            out["matvec_dp_bitwise"] = bool(torch.equal(dp_all, want.p))
            out["matvec_sinks_rel"] = float(
                ((dp.sinks - want.sinks).abs()
                 / want.sinks.abs().clamp_min(1e-300)).max())
        queue.put(out)
    finally:
        pt.environment.finalize()


def run_ranks(world, backend, t_final, tol, target=rank_solve, args=None):
    """``target`` (default ``rank_solve``) on ``world`` spawned processes
    (``pacmensl_tpu_torch.parallel.spawn.run_ranks``); their summaries by
    rank.  ``target`` takes ``(rank, world, port, backend, *args,
    queue)``, ``args`` defaulting to ``(t_final, tol)``.  A rank that
    fails or outlasts RANK_TIMEOUT fails the run, and every rank is
    stopped."""
    from pacmensl_tpu_torch.parallel import spawn
    args = (t_final, tol) if args is None else tuple(args)
    try:
        return spawn.run_ranks(world, backend, target, args,
                               timeout=RANK_TIMEOUT)
    except spawn.RankError as e:
        fail(f"the {backend} solve: {e}")


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
    sd = setup(pt.SensFspSolverMultiSinks(backend="box", odes_type="auto",
                                          device=dev), hs).solve(t_final, tol)
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
        return setup(pt.FspSolverMultiSinks(backend="box", odes_type="auto",
                                            device=dev), base).solve(t_final,
                                                                     tol)

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


def sens_phase(dev, smi, d5, mass_tol, run_entry, tables, same_twice,
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
    from pacmensl_tpu_torch.sys.events import tally
    from pacmensl_tpu_torch.tools import bench_configs

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
        # the library's other reading: the sinks as a dense reduction
        split = split_sinks(A, 3)
        sp, ss = split_apply(split, Pt)
        lerr = max(float((sp.T - kp).abs().max()),
                   float((ss.T - ks).abs().max()))
        check(lerr <= 1e-9 * float(kp.abs().max()),
              f"128^3 nb={nb}: the split CSR generator differs from K9 by "
              f"{lerr:.3e}")
        del sp, ss
        runs = {
            "plain": lambda: bk.box_action_synth_batched_reference(
                c, P, a, bb, geom),
            "single": lambda: [bk.box_action_synth(c, P[i], a, bb, geom)
                               for i in range(nb)],
            "K9": lambda: bk.box_action_synth_batched(c, P, a, bb, geom),
            "K9_K1": lambda: bk.box_action_batched(c, P, mask, a, viol,
                                                   geom),
            "library": lambda: torch.sparse.mm(A, Pt),
            "split": lambda: split_apply(split, Pt)}
        ms = timed(f"{label} nb={nb} per call: K9 (K3), {nb} single K3 "
                   f"launches, K9 (K1), plain, torch.sparse.mm of the CSR "
                   f"generator ({A.values().numel()} nonzeros) with the "
                   f"[n, {nb}] block (library), and of its state rows with "
                   f"the sinks' dense reduction (split)", runs,
                   ["plain", "single", "K9", "K9_K1", "library", "split",
                    "split", "library", "K9_K1", "K9", "single", "plain"],
                   {"plain": 10})
        tb = a.table_bytes()
        nbytes = nb * pr.box_action_bytes(n, n, R, True) + tb
        bnd = bound(nbytes, nb * 2 * (2 * R + 1) * n)
        print(f"[9a] {label} nb={nb}: K9 {ms['K9'] * 1e3:.1f} us "
              f"({ms['K9'] / nb * 1e3:.1f} per vector) against {nb} single "
              f"K3 launches {ms['single'] * 1e3:.1f} us "
              f"({ms['single'] / nb * 1e3:.1f} per vector), K9 (K1) "
              f"{ms['K9_K1'] / nb * 1e3:.1f} per vector; one batched launch "
              f"no slower: {ms['K9'] <= ms['single']}; bound "
              f"{bnd[0] * 1e3:.1f} us ({nbytes / 1e6:.1f} MB: {nb} x K3's "
              f"bytes, the tables once), {bnd[0] / ms['K9']:.3f} of it; "
              f"{smi}", flush=True)
        if k9 is None:
            k9 = {"ms": ms["K9"], "plain_ms": ms["plain"], "bound": bnd,
                  "library_ms": min(ms["library"], ms["split"])}
        del A, split, Pt, y, P, kp, ks, runs
        torch.cuda.empty_cache()
    del a, viol, mask, geom
    torch.cuda.empty_cache()

    # (b) hog1p_5d_sens, the path.  Its actions are counted through
    # tally, as the box kernel's launches are, so an action captured in
    # an Arnoldi iteration's CUDA graph counts at each replay
    actions = [0]
    action = SensOperator.action

    def one_more():
        actions[0] += 1

    def counted(self, t, y, out=None):
        tally(one_more)
        return action(self, t, y, out=out)
    SensOperator.action = counted
    try:
        # through bench_configs' sens_hog1p config
        s, d9, launch9, wall9 = run_entry(
            9, f"hog1p_5d_sens t={HOG_T_FINAL:g} tol={HOG_TOL:g}",
            lambda: bench_configs.run_sens_hog1p(
                pt.Options.from_argv(["-fsp_backend", "box"]), dev),
            HOG_TOL, mass_tol)
    finally:
        SensOperator.action = action
    check(isinstance(s._ode_solver, pt.BdfSolver),
          "hog1p_5d_sens did not run the BDF integrator")
    sop = s._operator
    subs = [o for o in sop.cxdA if o is not None]
    per = len(subs)
    for i, op in enumerate(sop.sub_ops()):
        check(op.synth_mask, f"hog1p_5d_sens operator {i}: not on K3")
        tables(9, f"hog1p_5d_sens final operator {i} (reactions "
                  f"{op.enable_reactions})", op)
    ev9 = s.get_event_log().events
    rhs = ev9["RHSEvaluation"].count
    cap9, rep9 = (ev9[k].count if k in ev9 else 0
                  for k in ("GMRESCapture", "GMRESReplay"))
    print(f"[9b] {actions[0]} sensitivity actions, {rhs} RHS evaluations "
          f"(GMRES's residual matvecs are not counted as RHS evaluations); "
          f"Arnoldi iterations: {cap9} captured, {rep9} replayed; "
          f"per action {launch9['batched_synth'] / actions[0]:.3f} batched "
          f"launch and {launch9['synth'] / actions[0]:.3f} K3 launches "
          f"(expected 1 and {per}); per RHS evaluation "
          f"{sum(launch9.values()) / rhs:.3f} launches", flush=True)
    check(launch9["batched_synth"] == actions[0]
          and launch9["synth"] == per * actions[0]
          and launch9["mask"] + launch9["batched_mask"] == 0,
          f"hog1p_5d_sens: {launch9} for {actions[0]} actions")
    check(0 < cap9 < rep9, f"hog1p_5d_sens: {cap9} Arnoldi iterations "
                           f"captured, {rep9} replayed")
    check(d9.num_states == SENS_STATES and rhs == SENS_RHS,
          f"hog1p_5d_sens: {d9.num_states} states after {rhs} RHS "
          f"evaluations, expected {SENS_STATES} after {SENS_RHS}")
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

    # (a) on the final operator and the solve's own vectors: p and both
    # sensitivities (nb = 3, the solve's own batch), and the two
    # sensitivities alone (nb = 2)
    op = sop.base
    nf = op.geom.n
    P3 = s._y.p.view(3, nf).clone()
    P2 = P3[1:].clone()
    del s, sop, subs
    torch.cuda.empty_cache()
    c = op.coefficients(HOG_T_FINAL)
    hb = op.data().bounds
    label = f"hog1p_5d_sens final {op.shape}"
    fviol = bo.violation_bits(op.space.constraints, op.stoichiometry,
                              op.shape, dev)
    for P in (P3, P2):
        check_batched(label, c, P, op.props, op.geom, bounds=hb)
        check_batched(label, c, P, op.props, op.geom,
                      mask=op.space.mask_bytes(), viol=fviol)
    nvalid = int(op.space.mask_bytes().sum())
    # the library yardstick on the [n, nb] block in both readings: one
    # torch.sparse.mm of the generator as CSR with its sink rows (about a
    # second a call here: one warm-up call, two timed) and of its state
    # rows with the sinks as a dense reduction
    A = generator_csr(c, op.space.mask_bytes(), op.prop_fields, fviol,
                      op.shape, op.stoichiometry, op.num_constraints)
    kp, ks = bk.box_action_synth_batched(c, P3, op.props, hb, op.geom)
    Pt = P3.T.contiguous()
    lib = library_readings(f"{label} nb=3", A, op.num_constraints, Pt,
                           (kp, ks), reps=2, warm=1, rounds=1,
                           readings=("csr",))
    lib.update(library_readings(f"{label} nb=3", A, op.num_constraints, Pt,
                                (kp, ks), readings=("split",)))
    del kp, ks, A, Pt
    torch.cuda.empty_cache()
    for P in (P3, P2):
        nb = P.shape[0]
        runs = {"plain": lambda: bk.box_action_synth_batched_reference(
                    c, P, op.props, hb, op.geom),
                "single": lambda: [bk.box_action_synth(c, P[i], op.props, hb,
                                                       op.geom)
                                   for i in range(nb)],
                "K9": lambda: bk.box_action_synth_batched(c, P, op.props, hb,
                                                          op.geom)}
        ms = timed(f"{label} nb={nb} per call: K9 (K3), {nb} single K3 "
                   f"launches, plain", runs,
                   ["plain", "single", "K9", "K9", "single", "plain"],
                   {"plain": 3, "single": 20, "K9": 20})
        if nb == 3:
            ms["library"] = min(lib.values())
        nbytes = nb * pr.box_action_bytes(nf, nf, op.props.num_reactions,
                                          True, n_valid=nvalid) \
            + op.props.table_bytes()
        bnd = bound(nbytes, 0)
        print(f"[9a] {label} nb={nb}: K9 {ms['K9'] * 1e3:.1f} us "
              f"({ms['K9'] / nb * 1e3:.1f} per vector) against {nb} single "
              f"K3 launches {ms['single'] * 1e3:.1f} us "
              f"({ms['single'] / nb * 1e3:.1f} per vector); "
              + (f"library with the [n, 3] block: {readings_text(lib)} "
                 f"(K9 / library {ms['K9'] / ms['library']:.4f}); "
                 if "library" in ms else "")
              + f"bound "
              f"{bnd[0] * 1e3:.1f} us ({nbytes / 1e6:.1f} MB: {nb} x K3's "
              f"bytes at {nvalid} valid of {nf} elements, the tables once), "
              f"{bnd[0] / ms['K9']:.3f} of it; {smi}", flush=True)
    del P, P2, runs
    # phase 11d at full width: K9w on the final operator, cut into 2 and
    # 4 slabs (no slab has an interior: one launch a slab), with the
    # solve's own vectors
    for slabs in (2, 4):
        k9w_check(dev, smi, f"hog1p_5d_sens final {op.shape}", c, P3,
                  op.props, op.geom, hb, op.space.mask_bytes(), fviol, slabs,
                  max_err, modes=("synth",), library=True, time_plain=False,
                  before=K9W_BEFORE_US[("hog1p_5d_sens final", slabs, 3)])
        torch.cuda.empty_cache()
    del P3, op, fviol
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


def ell_csr(op, c):
    """The compressed operator at coefficients ``c`` as a CSR matrix of
    ``n + nc`` rows, the sink rows last: the function its action computes
    on the ``n`` valid entries.  The library yardstick only."""
    import torch
    n, nc = op.n_states, op.num_constraints
    dev = op.device
    cr = torch.as_tensor(c, dtype=torch.float64, device=dev)
    rows = torch.arange(n, device=dev)
    off = op.off_val[:, :n] * cr[:, None]
    keep = off != 0
    r_off = rows.expand_as(off)[keep]
    c_off = op.src_idx[:, :n][keep]
    diag = -(cr[:, None] * op.diag_val[:, :n]).sum(0)
    sink_v = op.sink_w * cr[op.sink_r][None, :]
    sk = sink_v != 0
    r_s = (n + torch.arange(nc, device=dev)[:, None]).expand_as(sink_v)[sk]
    c_s = op.sink_x[None, :].expand_as(sink_v)[sk]
    idx = torch.stack([torch.cat([r_off, rows, r_s]),
                       torch.cat([c_off, rows, c_s])])
    vals = torch.cat([off[keep], diag, sink_v[sk]])
    return torch.sparse_coo_tensor(idx, vals, (n + nc, n)
                                   ).coalesce().to_sparse_csr()


def ell_phase(dev, smi, run_solve, final_operator, rep, d4, op4, p4, d_t2):
    """Phase 10: the compressed (ELL) backend and the stationary solver.
    (a) The repressilator on ELL from the start, phase 4's setting.  (b)
    Its action at the final state set against K3 on phase 4's final box,
    one torch.mv of the generator as CSR, and the action in GRAPH's
    order; the fill floor and the "auto" rule from these.  (c) A box
    solve to t = 2 that migrates on PACMENSL_BOX_MEM_BUDGET, against the
    one-device box solve ``d_t2`` of phase 7c.  (d) hog1p_5d_sens at
    phase 9c's setting on ELL against the box.  (e) The stationary law of
    the repressilator (BASELINE.json config 5) on the box, and of the
    birth-death model on both backends against Poisson(10).  In (c) and
    (e) K1 and K3 are held against their plain versions at the last box
    epoch (``final_operator``).  Returns the box kernel's launches in (c)
    and (e)'s repressilator solve."""
    import os
    import warnings
    import numpy as np
    import torch
    import pacmensl_tpu_torch as pt
    from pacmensl_tpu_torch.fsp import solver as fsp_solver
    from pacmensl_tpu_torch.ops import box_kernel as bk
    from pacmensl_tpu_torch.ops.vecops import FspVector
    from pacmensl_tpu_torch.statespace.partitioner import (
        PartitioningType, StatePartitioner)
    from pacmensl_tpu_torch.tools import bench_configs, ell_bench

    def hold_box(phase, target):
        """Checks the box kernels against their plain versions on the box
        operator and solution a migration leaves, then times the
        migration, on the solver ``target`` or on every solver of the
        class ``target``; returns the list of (seconds, states, t) it
        fills and a function that undoes the hook."""
        log = []
        orig = target._migrate_box_to_ell   # a function on a class
        own = "_migrate_box_to_ell" in vars(target)
        on_class = isinstance(target, type)

        def hooked(s):
            uncounted(lambda: final_operator(
                phase, "last box epoch before the migration", s, s._t_now))
            t0 = time.perf_counter()
            orig(s) if on_class else orig()
            torch.cuda.synchronize()
            log.append((time.perf_counter() - t0, s.num_states, s._t_now))
        target._migrate_box_to_ell = (hooked if on_class
                                      else lambda: hooked(target))

        def restore():
            if own:
                target._migrate_box_to_ell = orig
            else:
                delattr(target, "_migrate_box_to_ell")
        return log, restore

    def setup(s, bundle):
        s.set_model(bundle.model)
        s.set_constraint_functions(bundle.constraint)
        s.set_initial_bounds(bundle.bounds)
        s.set_expansion_factors(bundle.expansion_factors)
        s.set_initial_distribution(bundle.x0, bundle.p0)
        return s

    # (a) the repressilator on ELL at full size
    s = setup(pt.FspSolverMultiSinks(backend="ell", odes_type="krylov",
                                     device=dev), rep)
    d10, _, wall = run_solve("10a", f"repressilator on ELL t={SLICE_T_FINAL:g}"
                             f" tol={SLICE_TOL:g}", s, SLICE_T_FINAL,
                             SLICE_TOL, lambda k: 1.0e-8, kernel=False)
    check(s._backend_used == "ell" and isinstance(s._operator,
                                                  pt.EllOperator),
          "10a: the solve did not run on the compressed backend")
    ev = s.get_event_log().events
    l1 = l1_by_state(d10, d4)
    mg = ev["MatrixGeneration"]
    print(f"[10a] {d10.num_states} states on ELL against phase 4's "
          f"{d4.num_states} on the box; L1 {l1:.3e} (limit "
          f"{2 * SLICE_TOL:g}); MatrixGeneration {mg.total_s:.3f} s over "
          f"{mg.count} assemblies ({mg.total_s / mg.count * 1e3:.1f} ms "
          f"each), StatePartitioning {ev['StatePartitioning'].total_s:.3f} "
          f"s, ODESolve {ev['ODESolve'].total_s:.3f} s, wall {wall:.2f} s; "
          f"{smi}", flush=True)
    check(l1 <= 2 * SLICE_TOL, f"10a: L1 to phase 4 {l1:.3e} > "
                               f"{2 * SLICE_TOL:g}")

    # (b) the action at the final state set
    op, y = s._operator, s._y
    n, nc = op.n_states, op.num_constraints
    c = op.model.coefficients(SLICE_T_FINAL)
    A = ell_csr(op, c)
    pv = y.p[:n].contiguous()
    ref = torch.mv(A, pv)
    got = op.action(SLICE_T_FINAL, y)
    scale = float(ref[:n].abs().max())
    e_dp = float((got.p[:n] - ref[:n]).abs().max()) / scale
    e_s = float(((got.sinks - ref[n:]).abs()
                 / ref[n:].abs().clamp_min(1e-300)).max())
    print(f"[10b] ELL action at {n} states (n_pad {op.n_pad}, {op.nnz()} "
          f"nonzeros, {op.sink_x.numel()} boundary transitions) against "
          f"one torch.mv of the generator as CSR: dp {e_dp:.3e} relative "
          f"to its largest, sinks {e_s:.3e} relative (limits 1e-12)",
          flush=True)
    check(e_dp <= 1e-12 and e_s <= 1e-12,
          f"10b: the ELL action differs from the CSR product ({e_dp:.3e}, "
          f"{e_s:.3e})")
    check(not bool(got.p[n:].any()), "10b: nonzero dp past the states")
    # the same set in GRAPH's (reverse Cuthill-McKee) order
    t0 = time.perf_counter()
    ss2 = pt.StateSet(rep.model.stoichiometry, s.constraints,
                      init_states=s._space.states)
    order = StatePartitioner(PartitioningType.GRAPH).partition(
        ss2.states, rep.model.stoichiometry, 1, state2index=ss2.state2index,
        need_boundaries=False).order
    ss2.reorder(order)
    op_g = pt.EllOperator(rep.model, ss2, device=dev)
    t_rcm = time.perf_counter() - t0
    pg = torch.zeros_like(y.p)
    pg[torch.as_tensor(ss2.state2index(s._space.states), device=dev)] = pv
    yg = FspVector(p=pg, sinks=y.sinks)
    gg = op_g.action(SLICE_T_FINAL, yg)
    inv = torch.as_tensor(ss2.state2index(s._space.states), device=dev)
    e_g = float((gg.p[inv] - got.p[:n]).abs().max()) / scale
    check(e_g <= 1e-12, f"10b: the action in GRAPH order differs "
                        f"({e_g:.3e})")
    c4 = op4.model.coefficients(SLICE_T_FINAL)
    runs = {"ELL": lambda: op.action(SLICE_T_FINAL, y),
            "K3": lambda: op4.action(SLICE_T_FINAL,
                                     FspVector(p=p4, sinks=None), c=c4),
            "CSR": lambda: torch.mv(A, pv),
            "ELL_GRAPH": lambda: op_g.action(SLICE_T_FINAL, yg)}
    t = {k: [] for k in runs}
    # the ELL action through tools/ell_bench.py's timer
    ell_ops = {"ELL": (op, y), "ELL_GRAPH": (op_g, yg)}
    for k in ("ELL", "K3", "CSR", "ELL_GRAPH", "ELL_GRAPH", "CSR", "K3",
              "ELL"):
        if k in ell_ops:
            t[k].append(1e3 * ell_bench.time_action(
                *ell_ops[k], iters=100, t=SLICE_T_FINAL))
        else:
            t[k].append(time_ms(runs[k], reps=100))
    ell_ms, k3_ms = min(t["ELL"]), min(t["K3"])
    box_n = int(np.prod(op4.shape))
    floor = (k3_ms / box_n) / (ell_ms / n)
    fill = d4.num_states / box_n
    # R gathers of p (int64 index, value), the diagonal, p, dp, sinks
    R = rep.model.num_reactions
    nbytes = 8 * (3 * R * op.n_pad + 2 * op.n_pad
                  + op.sink_x.numel() * (2 + nc))
    bnd = bound(nbytes, 2 * op.nnz())
    print(f"[10b] us per action (order ELL K3 CSR GRAPH GRAPH CSR K3 ELL): "
          + ", ".join(f"{k} " + " / ".join(f"{v * 1e3:.1f}" for v in vs)
                      for k, vs in t.items())
          + f"; ELL {ell_ms / n * 1e6:.3f} ns per state, K3 "
          f"{k3_ms / box_n * 1e6:.4f} ns per box element ({op4.shape}); "
          f"bound of the ELL action {bnd[0] * 1e3:.1f} us ({nbytes / 1e6:.1f}"
          f" MB, {bnd[1]}); GRAPH ordering took {t_rcm:.2f} s; {smi}",
          flush=True)
    auto = "box" if floor < fill else "ell"
    print(f"[10b] fill floor (K3 per box element / ELL per state) "
          f"{floor:.4f}; the repressilator's final fill {fill:.4f}; the "
          f"port's BOX_FILL_FLOOR {fsp_solver.BOX_FILL_FLOOR}; measured "
          f"rule for custom constraints under auto: {auto} (the port's: "
          f"box on a card); GRAPH order's time over the insertion order's "
          f"{min(t['ELL_GRAPH']) / ell_ms:.4f}", flush=True)
    check(auto == "box", "10b: the measured fill floor puts custom "
                         "constraints on ELL, the port starts them on the box")
    del s, op, y, A, pv, ref, got, ss2, op_g, pg, yg, gg, runs
    torch.cuda.empty_cache()

    # (c) migration on the memory budget, to t = 2
    os.environ["PACMENSL_BOX_MEM_BUDGET"] = str(MIGRATE_BUDGET)
    try:
        s = setup(pt.FspSolverMultiSinks(backend="box", odes_type="krylov",
                                         device=dev), rep)
        t_mig, _ = hold_box("10c", s)
        d10c, launch10c, wall = run_solve(
            "10c", f"repressilator box -> ELL t={GLOO_T_FINAL:g}", s,
            GLOO_T_FINAL, SLICE_TOL, lambda k: 1.0e-8)
    finally:
        del os.environ["PACMENSL_BOX_MEM_BUDGET"]
    l1 = l1_by_state(d10c, d_t2)
    print(f"[10c] budget {MIGRATE_BUDGET:g} B: migrated at t = "
          f"{t_mig[0][2]:.4g} with {t_mig[0][1]} states in "
          f"{t_mig[0][0]:.3f} s (migrations: {len(t_mig)}); backend at the "
          f"end {s._backend_used}, {d10c.num_states} states, K3 launches "
          f"before the migration {launch10c['synth']}; L1 to the box-only "
          f"solve of 7c ({d_t2.num_states} states) {l1:.3e}; wall "
          f"{wall:.2f} s", flush=True)
    check(s._backend_used == "ell" and len(t_mig) == 1,
          "10c: the solve did not migrate to the compressed backend")
    check(l1 <= 2 * SLICE_TOL, f"10c: L1 to the box-only solve {l1:.3e}")
    del s
    torch.cuda.empty_cache()

    # (d) sensitivities on ELL at phase 9c's setting, against the box.
    # BDF's error norm is a mean over the vector's entries, the box's
    # capacity or ELL's n_pad, so the two take other steps and agree only
    # to the integrator's error: p to 1e-6, each sensitivity (a small
    # vector, whose error is relative to p's scale) to SENS_BDF_LIMIT.
    # Krylov's 2-norms do not count the structural zeros: under it the
    # backends take the same steps, and all are held to 1e-6.
    hs = pt.models.hog1p_5d_sens()
    for odes in ("auto", "krylov"):
        sd = {}
        for backend in ("ell", "box"):
            s = setup(pt.SensFspSolverMultiSinks(
                backend=backend, odes_type=odes, device=dev), hs)
            s.set_ode_tolerances(FD_RTOL, FD_ATOL)
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)  # Krylov/tv
                sd[backend] = s.solve(FD_T_FINAL, FD_TOL)
            torch.cuda.synchronize()
            ev = s.get_event_log().events
            print(f"[10d] hog1p_5d_sens t={FD_T_FINAL:g} tol={FD_TOL:g} "
                  f"{type(s._ode_solver).__name__} on {s._backend_used}: "
                  f"{sd[backend].num_states} states, epochs "
                  f"{ev['ODESolve'].count}, RHS evaluations "
                  f"{ev['RHSEvaluation'].count}, wall "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            check(s._backend_used == backend,
                  f"10d: ran on {s._backend_used}")
            del s
            torch.cuda.empty_cache()
        ke = {tuple(x): i for i, x in enumerate(sd["ell"].states)}
        check(sd["ell"].num_states == sd["box"].num_states
              and all(tuple(x) in ke for x in sd["box"].states),
              "10d: the two backends' state sets differ")
        perm = np.array([ke[tuple(x)] for x in sd["box"].states])
        rels = [float(np.abs(a[perm] - b).sum() / np.abs(b).sum())
                for a, b in [(sd["ell"].p, sd["box"].p)] + list(
                    zip(sd["ell"].dp, sd["box"].dp))]
        fim = sd["ell"].compute_fim()
        asym = float(np.abs(fim - fim.T).max() / np.abs(fim).max())
        lim = 1e-6 if odes == "krylov" else SENS_BDF_LIMIT
        print(f"[10d] {odes}: ELL against the box, relative L1 of p and "
              f"each sensitivity {', '.join(f'{r:.3e}' for r in rels)} "
              f"(limits 1e-6, {lim:g}); ELL's FIM {fim.tolist()}, "
              f"asymmetry {asym:.3e}", flush=True)
        check(rels[0] <= 1e-6 and max(rels[1:]) <= lim,
              f"10d ({odes}): ELL and box differ by {rels}")
        check(np.isfinite(fim).all() and asym <= 1e-12,
              "10d: FIM not finite and symmetric")

    # (e) stationary: the birth-death oracle on both backends, then the
    # repressilator, BASELINE.json config 5
    from scipy.stats import poisson as poisson_law
    for backend in ("box", "ell"):
        b = pt.models.birth_death(birth=1.0, death=0.1)
        s = pt.StationaryFspSolverMultiSinks(backend=backend, device=dev)
        s.set_model(b.model)
        s.set_initial_bounds([10])
        s.set_expansion_factors([0.5])
        s.set_initial_distribution(b.x0, b.p0)
        d = s.solve(1.0e-7)
        pdf = poisson_law.pmf(d.states[:, 0], 10.0)
        l1 = float(np.abs(d.p - pdf / pdf.sum()).sum())
        print(f"[10e] birth-death stationary on {backend}: {d.num_states} "
              f"states, L1 to Poisson(10) {l1:.3e} (limit 1e-6)", flush=True)
        check(l1 < 1e-6, f"10e: birth-death on {backend}: L1 {l1:.3e}")
    # through bench_configs' stationary_rep config, at STAT_TOL
    t_mig, restore = hold_box("10e", pt.StationaryFspSolverMultiSinks)
    torch.cuda.synchronize()
    bk.KERNEL.reset_counts()
    try:
        s, d, wall = bench_configs.run_stationary_rep(
            pt.Options.from_argv(["-sfsp_tol", str(STAT_TOL)]), dev)
    finally:
        restore()
    launch10e = dict(bk.KERNEL.launches)
    if s._backend_used == "box":
        final_operator("10e", "stationary repressilator", s, 0.0)
    else:
        print(f"[10e] migrated at {t_mig[0][1]} states", flush=True)
    for k, r in enumerate(s.rounds_):
        print(f"[10e] round {k}: {r.backend}, {r.num_states} states, GMRES "
              f"{r.n_matvecs} matvecs, preconditioned residual "
              f"{r.res_norm:.3e}, raw {r.raw_res_norm:.3e}, sinks "
              f"{np.array2string(r.sinks, precision=3)}, {r.seconds:.2f} s",
              flush=True)
    mass, sinks = d.sum(), np.asarray(s.sinks_)
    print(f"[10e] stationary repressilator sfsp_tol={STAT_TOL:g}: "
          f"{d.num_states} states (the TPU's float32 wall: 96,142), "
          f"{len(s.rounds_)} rounds, backend at the end {s._backend_used}, "
          f"bounds {d.bounds.tolist()}, sum(pi) - 1 = {mass - 1:.3e}, "
          f"min(pi) {d.p.min():.3e}, max sink {sinks.max():.3e}, kernel "
          f"launches {launch10e}, wall {wall:.2f} s; {smi}", flush=True)
    check(abs(mass - 1.0) <= 1e-12, f"10e: sum(pi) - 1 = {mass - 1:.3e}")
    check(d.p.min() >= -1e-12, f"10e: min(pi) = {d.p.min():.3e}")
    check((sinks <= STAT_TOL).all(), f"10e: sinks {sinks} > {STAT_TOL:g}")
    check(d.num_states > 96142, f"10e: {d.num_states} states, not past "
                                "the TPU's float32 wall of 96,142")
    check(sum(launch10e.values()) > 0, "10e: no box kernel launch")
    del s
    torch.cuda.empty_cache()
    return launch10c, launch10e, d10


def k9w_check(dev, smi, label, c, P, a, geom, bounds, mask, viol, slabs,
              max_err, modes=("synth", "mask"), library=False,
              time_plain=True, before="not measured"):
    """Phase 11d: the batched launch on a window (K9w) on ``geom``'s box
    cut into ``slabs`` axis-0 slabs, each window holding every vector's
    halo planes as ShardedBoxAction.batched's exchange delivers them, in
    one launch per slab.  In each of ``modes`` on every slab: the
    launch's dp bitwise the plain version's and nb single K4 launches',
    sinks bitwise the K4 launches' and within 1e-12 of the plain
    version's (relative to
    each vector's largest sink, or, where that vector's sinks cancel to
    less than 1/SINK_CANCEL of its summed terms (its largest sink of |p|),
    relative to those terms: a sensitivity's sinks on a slab can cancel to
    1e-8 of their terms, where two summation orders differ by more than
    1e-12 of the sum; both readings are printed), two launches bitwise
    equal; the assembled dp bitwise the whole box's K9, the summed sinks
    within 1e-12 of its.  Timed with CUDA events (100 calls) beside nb K4
    sweeps, the unsharded K9, the plain version (only with
    ``time_plain``) and, with ``library``, one torch.sparse.mm of each
    slab's CSR state rows with the [n, nb] block and the sinks as a dense
    reduction (:func:`split_sinks`); ``before``: the sweep's time for the
    shape before the one-pass tail (``K9W_BEFORE_US``), printed beside.
    Returns K9w's record (ms per sweep; ``graph_ms``: K9w's, K9's and the
    K4 sweeps' replayed from a CUDA graph)."""
    import numpy as np
    import torch
    from pacmensl_tpu_torch.ops import box_kernel as bk
    from pacmensl_tpu_torch.ops import probes as pr
    from pacmensl_tpu_torch.parallel.halo_box import halo_width, window_rows
    nb, shape, plane = P.shape[0], geom.shape, geom.plane
    w0 = halo_width(geom.stoich)
    R = geom.num_reactions
    wins = []
    for g, ps, halos, o, rows in k9w_windows(geom, P, slabs):
        wm = window_rows(mask.reshape(shape), o, rows).reshape(-1)
        wv = (torch.stack([window_rows(v.reshape(shape), o, rows)
                           .reshape(-1) for v in viol])
              if viol is not None else None)
        wins.append((g, ps, halos, a.window(o, rows), wm, wv))

    def launch(mode, w, i=None, plain=False):
        """K9w on window ``w`` (K4 on vector ``i`` where given)."""
        g, ps, (up, dn), wa, wm, wv = w
        if i is not None:
            ps, up, dn = ps[i], up[i], dn[i]
        if ps.dim() == 1:
            if mode == "synth":
                return bk.box_action_synth(c, ps, wa, bounds, g,
                                           halos=(up, dn))
            return bk.box_action(c, ps, wm, wa, wv, g, halos=(up, dn))
        if mode == "synth":
            fn = (bk.box_action_synth_batched_reference if plain
                  else bk.box_action_synth_batched)
            return fn(c, ps, wa, bounds, g, halos=(up, dn))
        fn = (bk.box_action_batched_reference if plain
              else bk.box_action_batched)
        return fn(c, ps, wm, wa, wv, g, halos=(up, dn))

    def rel_err(ks, rs, mag):
        """``(held, old)``: ``ks`` against ``rs`` per vector, relative to
        its largest sink (old), and, where its sinks cancel to less than
        1/SINK_CANCEL of its summed terms (``mag``, the sinks of |p|),
        relative to those terms instead (held)."""
        big = rs.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
        terms = mag.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
        d = (ks - rs).abs().amax(dim=-1, keepdim=True)
        held = torch.where(terms > SINK_CANCEL * big, d / terms, d / big)
        return float(held.max()), float((d / big).max())

    whole = bk.box_action_synth_batched(c, P, a, bounds, geom)
    whole_mag = bk.box_action_synth_batched(c, P.abs(), a, bounds, geom)[1]
    for mode in modes:
        dps, sk, rel, old = [], 0, 0.0, 0.0
        for j, w in enumerate(wins):
            tag = f"[11d] {label} K9w {mode} slab {j}"
            kp, ks = same_twice(tag, lambda: launch(mode, w))
            rp, rs = launch(mode, w, plain=True)
            g, ps, (up, dn) = w[:3]
            mag = launch(mode, (g, ps.abs(), (up.abs(), dn.abs())) + w[3:],
                         plain=True)[1]
            err = float(max((kp - rp).abs().max(), (ks - rs).abs().max()))
            check(torch.equal(kp, rp), f"{tag}: dp is not bitwise the "
                                       f"plain version's (max abs "
                                       f"{err:.3e})")
            held, o = rel_err(ks, rs, mag)
            rel, old = max(rel, held), max(old, o)
            check(rel <= 1e-12, f"{tag}: sinks {rel:.3e} from the plain "
                                "version's, relative")
            each = [launch(mode, w, i) for i in range(nb)]
            check(torch.equal(kp, torch.stack([q[0] for q in each]))
                  and torch.equal(ks, torch.stack([q[1] for q in each])),
                  f"{tag}: not bitwise {nb} K4 launches")
            max_err["batched_sharded"] = max(max_err["batched_sharded"],
                                             err)
            dps.append(kp)
            sk = sk + ks
        check(torch.equal(torch.cat(dps, dim=1), whole[0]),
              f"[11d] {label} K9w {mode}: the assembled dp is not bitwise "
              "the whole box's K9")
        srel, sold = rel_err(sk, whole[1], whole_mag)
        check(srel <= 1e-12, f"[11d] {label} K9w {mode}: summed sinks "
                             f"{srel:.3e} from the whole box's K9")
        print(f"[11d] K9w ({mode}) {label}: nb={nb}, {slabs} slabs of "
              f"{[w[0].out_hi - w[0].out_lo for w in wins]} rows, windows "
              f"of {[w[0].shape[0] for w in wins]}; dp bitwise the plain "
              f"version's and {nb} K4 launches'; sinks bitwise the K4 "
              f"launches' and within {rel:.3e} of the plain version's "
              f"({old:.3e} of the largest sink); assembled dp bitwise the "
              f"whole box's K9, summed sinks within {srel:.3e} ({sold:.3e} "
              f"of the largest sink)", flush=True)
    runs = {"plain": lambda: [launch("synth", w, plain=True) for w in wins],
            "K4": lambda: [launch("synth", w, i)
                           for i in range(nb) for w in wins],
            "K9w": lambda: [launch("synth", w) for w in wins],
            "K9": lambda: bk.box_action_synth_batched(c, P, a, bounds, geom)}
    order = ["plain", "K4", "K9w", "K9", "K9", "K9w", "K4", "plain"]
    if not time_plain:
        del runs["plain"]
        order = order[1:-1]
    if library:
        # each slab's CSR rows with the sinks as a dense reduction
        # (split_sinks): one CSR product with the sink rows is a long
        # serial row a sink, about a second a call at a final capacity
        # (9a prints both readings there)
        Pt = P.T.contiguous()
        splits = [split_sinks(generator_csr(
            c, mask, a.dense(), viol, shape, geom.stoich, geom.nc,
            ((w[0].origin0 + w0) * plane, (w[0].origin0 + w[0].out_hi)
             * plane)), geom.nc) for w in wins]
        for w, S in zip(wins, splits):
            yp, ys = split_apply(S, Pt)
            kp, ks = launch("synth", w)
            lerr = max(float((yp.T - kp).abs().max()),
                       float((ys.T - ks).abs().max()))
            check(lerr <= 1e-9 * float(kp.abs().max()),
                  f"[11d] {label}: a slab's CSR rows differ from K9w by "
                  f"{lerr:.3e}")
        del yp, ys
        runs["library"] = lambda: [split_apply(S, Pt) for S in splits]
        half = len(order) // 2
        order = order[:half] + ["library", "library"] + order[half:]
    # the plain version is timed over fewer calls at a final capacity
    big = P[0].numel() > 1e7
    reps = {"plain": 3, "library": 20} if big else {"plain": 10}
    t = {k: [] for k in runs}
    for k in order:
        t[k].append(time_ms(runs[k], reps=reps.get(k, 100)))
    ms = {k: float(np.mean(v)) for k, v in t.items()}
    # the device's time without the host's cost per launch
    dev_ms = {k: graph_ms(runs[k]) for k in ("K9w", "K9", "K4")}
    tb = a.table_bytes()
    nbytes = sum(nb * pr.box_action_bytes(
        w[0].n, w[0].n_out, R, True, n_valid=sum(
            int((w[4][lo * plane:hi * plane] != 0).sum())
            for lo, hi in w[0].read_spans)) + tb for w in wins)
    bnd = bound(nbytes, nb * 2 * (2 * R + 1) * geom.n)
    k4 = f"{nb} K4 sweeps"
    print(f"[11d] {label} nb={nb}, a sweep of {slabs} slabs (us; order "
          f"{' '.join(order)}; K4: {k4}): " + ", ".join(
              f"{k} " + " / ".join(f"{v * 1e3:.1f}" for v in vs)
              for k, vs in t.items()) + f"; bound {bnd[0] * 1e3:.1f} us "
          f"({nbytes / 1e6:.1f} MB: each vector's p over the rows its "
          f"slab's rows read, halos included, and its dp, the tables once "
          f"a slab): K9w {bnd[0] / ms['K9w']:.3f} of it"
          + "; replayed from a CUDA graph: " + ", ".join(
              f"{k} {v * 1e3:.1f}" for k, v in dev_ms.items())
          + f"; K9w before the one-pass tail: {before}; "
          f"K9w no slower than {k4}: "
          f"{ms['K9w'] <= ms['K4']}; {smi}", flush=True)
    return {"ms": ms["K9w"], "plain_ms": ms.get("plain"), "bound": bnd,
            "library_ms": ms.get("library"), "k4_ms": ms["K4"],
            "k9_ms": ms["K9"], "graph_ms": dev_ms}


def rank_ell_solve(rank, world, port, backend, t_final, tol, queue):
    """Phase 11c on one rank: the repressilator on ``backend="ell"`` over
    the mesh of ``world`` ranks (no kernel: the ELL gathers and the
    exchange are plain PyTorch); puts its summary (and on rank 0 the
    distribution) on ``queue``."""
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import pacmensl_tpu_torch as pt
    from pacmensl_tpu_torch.ops import box_kernel as bk
    pt.environment.init(backend=backend, world_size=world, rank=rank,
                        init_method=f"tcp://127.0.0.1:{port}",
                        timeout=RANK_TIMEOUT)
    try:
        calls = [0]
        action = pt.ShardedEllOperator.action

        def counted(self, *args, **kw):
            calls[0] += 1
            return action(self, *args, **kw)
        pt.ShardedEllOperator.action = counted
        mesh = pt.make_mesh("cuda")
        rep = pt.models.repressilator()
        s = pt.FspSolverMultiSinks(backend="ell", odes_type="krylov",
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
        op = s._operator
        states = s._space.copy_states()
        out = {"rank": rank, "device": str(mesh.device), "wall": wall,
               "matvecs": calls[0], "launches": dict(bk.KERNEL.launches),
               "epochs": ev["ODESolve"].count,
               "rhs": ev["RHSEvaluation"].count,
               "n_pad": op.n_pad, "shard_len": op.shard_len,
               "halo_width": op.halo_width,
               "comm": op.comm_values_per_matvec(),
               "sent": op.values_sent_per_matvec(),
               "n_states": states.shape[0],
               "checksum": int(np.sum(states.astype(np.int64)
                                      * np.arange(1, states.shape[1] + 1))),
               "steps": (np.array(tr.model_time), np.array(tr.step_h),
                         np.array(tr.aux)),
               "sinks": np.asarray(d.sinks)}
        if rank == 0:
            out.update(states=d.states, p=d.p, bounds=d.bounds)
        queue.put(out)
    finally:
        pt.environment.finalize()


def rank_sens_solve(rank, world, port, backend, queue):
    """Phase 11e on one rank: hog1p_5d_sens at phase 9c's setting under
    Krylov over the mesh of ``world`` ranks on the box (K9w and K4) and
    on ELL (the sharded compressed operator); puts each solve's summary
    and distribution on ``queue``, with per sensitivity action the mesh's
    halo exchanges and all-reduces and the K9w and K4 launches."""
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import pacmensl_tpu_torch as pt
    from pacmensl_tpu_torch.ops import box_kernel as bk
    from pacmensl_tpu_torch.ops.sens_operator import SensOperator
    pt.environment.init(backend=backend, world_size=world, rank=rank,
                        init_method=f"tcp://127.0.0.1:{port}",
                        timeout=RANK_TIMEOUT)
    try:
        mesh = pt.make_mesh("cuda")
        out = {"rank": rank}
        per_action = []
        action = SensOperator.action
        k9w_keys = [k for k in bk.MODES if k.startswith("batched_sharded")]

        def counted(self, t, y):
            n0 = (mesh.halo_exchanges, mesh.all_reduces,
                  sum(bk.KERNEL.launches[k] for k in k9w_keys),
                  bk.KERNEL.launches["sharded_synth"]
                  + bk.KERNEL.launches["sharded_mask"])
            got = action(self, t, y)
            n1 = (mesh.halo_exchanges, mesh.all_reduces,
                  sum(bk.KERNEL.launches[k] for k in k9w_keys),
                  bk.KERNEL.launches["sharded_synth"]
                  + bk.KERNEL.launches["sharded_mask"])
            per_action.append([b - a for a, b in zip(n0, n1)])
            return got
        SensOperator.action = counted
        for fsp_backend in ("box", "ell"):
            s = sens_solver(pt, fsp_backend, "krylov", mesh=mesh)
            torch.cuda.synchronize()
            bk.KERNEL.reset_counts()
            per_action.clear()
            t0 = time.perf_counter()
            d = s.solve(FD_T_FINAL, FD_TOL)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ev = s.get_event_log().events
            sh = (s._operator.base.sharded if fsp_backend == "box"
                  else None)
            if sh is not None:      # phase 12d: the halo of the box order
                out["layout"] = {
                    "orders": list(s.axis_orders_),
                    "capacity": tuple(s._space.shape), "w0": sh.w0,
                    "plane": sh.plane,
                    "per_matvec": sh.comm_values_per_matvec(),
                    "per_rank": sh.w0 * sh.plane}
            out[fsp_backend] = {
                "wall": wall, "states": d.states, "p": d.p, "dp": d.dp,
                "launches": dict(bk.KERNEL.launches),
                "plain": dict(bk.KERNEL.plain_cuda_calls),
                "rhs": ev["RHSEvaluation"].count,
                "steps": np.array(s.step_trace.model_time),
                "per_action": np.array(per_action, dtype=np.int64)
                .reshape(-1, 4)}
            del s
        queue.put(out)
    finally:
        pt.environment.finalize()


def sens_solver(pt, fsp_backend, odes_type, mesh=None, device=None):
    """hog1p_5d_sens at phase 9c's setting (t = 3, fsp_tol 1e-6, ODE
    tolerances 1e-9 and 1e-14) on ``fsp_backend``."""
    hs = pt.models.hog1p_5d_sens()
    s = pt.SensFspSolverMultiSinks(backend=fsp_backend, odes_type=odes_type,
                                   mesh=mesh, device=device)
    s.set_model(hs.model)
    s.set_constraint_functions(hs.constraint)
    s.set_initial_bounds(hs.bounds)
    s.set_expansion_factors(hs.expansion_factors)
    s.set_initial_distribution(hs.x0, hs.p0)
    s.set_ode_tolerances(FD_RTOL, FD_ATOL)
    return s


def petsc_phase(dev, smi, run_solve, rep, d4, d_t2, d10, max_err):
    """Phase 11: (a) the repressilator of phase 4 under
    ``-fsp_odes_type petsc`` (RK, K3), against phase 4's distribution;
    (b) the same under ``-ts_type cn`` to ``CN_T_FINAL`` against a
    one-device Krylov solve; (c) the repressilator on ELL over
    one NCCL rank per card against 10a's ``d10``, and over two gloo ranks
    on the card to t = 2 against ``d_t2``; (d) K9w at 128^3 on 4 slabs;
    (e) hog1p_5d_sens at phase 9c's setting over two gloo ranks on the
    box (K9w) and on ELL against one-device solves.  Returns the box
    kernel's launches in (a) and (b), K9w's launches over (e)'s ranks and
    K9w's record at 128^3 (nb = 3)."""
    import numpy as np
    import torch
    import pacmensl_tpu_torch as pt
    from pacmensl_tpu_torch.ops import box_kernel as bk
    from pacmensl_tpu_torch.ops import box_operator as bo

    def petsc(ts):
        s = pt.FspSolverMultiSinks(backend="box", device=dev)
        s.set_from_options(pt.Options.from_argv(
            ["-fsp_odes_type", "petsc"] + (["-ts_type", ts] if ts else [])))
        s.set_model(rep.model)
        s.set_constraint_functions(rep.constraint)
        s.set_initial_bounds(rep.bounds)
        s.set_expansion_factors(rep.expansion_factors)
        s.set_initial_distribution(rep.x0, rep.p0)
        return s

    def halvings(s):
        """Counts the FSP halvings of ``s``'s RK or CN integrators."""
        n = [0]
        make = s._make_ode_solver

        def counted(*args):
            solver = make(*args)
            step = solver._decision

            def decision(*a, **kw):
                dec = step(*a, **kw)
                if dec[0] <= 1.0 and bool(dec[1]) and dec[2:].max() > 0:
                    n[0] += 1
                return dec
            solver._decision = decision
            return solver
        s._make_ode_solver = counted
        return n

    # 11b's yardstick: the one-device Krylov solve to CN_T_FINAL
    s = pt.FspSolverMultiSinks(backend="box", odes_type="krylov", device=dev)
    s.set_model(rep.model)
    s.set_constraint_functions(rep.constraint)
    s.set_initial_bounds(rep.bounds)
    s.set_expansion_factors(rep.expansion_factors)
    s.set_initial_distribution(rep.x0, rep.p0)
    d_cn = s.solve(CN_T_FINAL, SLICE_TOL)
    del s
    launches = {}
    for key, ts, t_final, want, wname in (
            ("11a", None, SLICE_T_FINAL, d4, "phase 4's Krylov solve"),
            ("11b", "cn", CN_T_FINAL, d_cn,
             f"a one-device Krylov solve to t = {CN_T_FINAL:g}")):
        s = petsc(ts)
        n_halve = halvings(s)
        # RK's and CN's error control holds each entry to about
        # atol + rtol |p| a step, so an entry near 0 may drift below it by
        # atol a step (RK: -1.044e-12 after 2,222 steps on an H100)
        d, launch, wall = run_solve(
            key, f"repressilator t={t_final:g} tol={SLICE_TOL:g} under "
                 f"-fsp_odes_type petsc{' -ts_type ' + ts if ts else ''}",
            s, t_final, SLICE_TOL, lambda k: 1.0e-8,
            neg_tol=lambda k: max(1.0e-12, k * s.ode_atol))
        cls = pt.CNSolver if ts else pt.RKSolver
        check(type(s._ode_solver) is cls,
              f"{key}: the solve ran {type(s._ode_solver).__name__}")
        ev = s.get_event_log().events
        l1 = l1_by_state(d, want)
        print(f"[{key}] {type(s._ode_solver).__name__}: steps "
              f"{ev['ODESteps'].count}, rejected "
              f"{ev['ODEStepsRejected'].count} (FSP halvings among them "
              f"{n_halve[0]}), RHS evaluations {ev['RHSEvaluation'].count}, "
              f"K3 launches {launch['synth']}, wall {wall:.2f} s; L1 to "
              f"{wname} {l1:.3e} (limit {2 * SLICE_TOL:g}); {smi}",
              flush=True)
        check(launch["synth"] > 0 and launch["mask"] == 0,
              f"{key}: launches {launch}")
        check(l1 <= 2 * SLICE_TOL, f"{key}: L1 to {wname} {l1:.3e}")
        launches[key] = launch
        del s
        torch.cuda.empty_cache()

    # (c) the compressed backend over ranks
    for key, world, backend, t_final, want, wname in (
            ("11c", torch.cuda.device_count(), "nccl", SLICE_T_FINAL, d10,
             "10a's one-device ELL solve"),
            ("11c", 2, "gloo", GLOO_T_FINAL, d_t2,
             "phase 7c's one-device box solve")):
        res = run_ranks(world, backend, t_final, SLICE_TOL,
                        target=rank_ell_solve)
        r0 = res[0]
        for r in res:
            check(all(np.array_equal(x, y) for x, y in
                      zip(r["steps"], r0["steps"])),
                  f"{key}: rank {r['rank']} took other steps than rank 0")
            check(r["n_states"] == r0["n_states"]
                  and r["checksum"] == r0["checksum"]
                  and np.array_equal(r["sinks"], r0["sinks"]),
                  f"{key}: rank {r['rank']}'s state set or sinks differ")
            check(sum(r["launches"].values()) == 0,
                  f"{key}: rank {r['rank']} launched {r['launches']}")
        pv = r0["p"]
        got = pt.DiscreteDistribution(t=t_final, states=r0["states"], p=pv,
                                      bounds=r0["bounds"], sinks=r0["sinks"])
        l1 = l1_by_state(got, want)
        mass = float(pv.sum())
        print(f"[{key}] repressilator on ELL t={t_final:g} over {world} "
              f"{backend} rank(s): {pv.size} states, epochs {r0['epochs']}, "
              f"RHS evaluations {r0['rhs']}, steps {r0['steps'][0].size} "
              f"(equal on every rank, and the state sets' counts and "
              f"checksums), matvecs {r0['matvecs']}, wall "
              + " / ".join(f"{r['wall']:.2f}" for r in res)
              + f" s; n_pad {r0['n_pad']}, shard_len {r0['shard_len']}, "
              f"halo_width {r0['halo_width']}; values crossing ranks per "
              f"matvec {r0['sent']} (the reference's padded count "
              f"{r0['comm']}); sum(p) {mass:.10f}; L1 to {wname} {l1:.3e} "
              f"(limit {2 * SLICE_TOL:g}), {want.num_states} states there",
              flush=True)
        check(np.isfinite(pv).all() and pv.min() > -1e-12
              and mass >= 1.0 - SLICE_TOL, f"{key}: output checks")
        check(l1 <= 2 * SLICE_TOL, f"{key}: L1 {l1:.3e}")
        check(abs(pv.size - want.num_states) <= 0.05 * want.num_states,
              f"{key}: {pv.size} states, not within 5% of "
              f"{want.num_states}")

    # (d) K9w at 128^3, 7a's cut
    shape = (BENCH_EDGE,) * 3
    n = int(np.prod(shape))
    stoich = rep.model.stoichiometry
    bb = np.array([BENCH_EDGE - 1] * 3)
    cs = pt.ConstraintSet(None, bb, None, 3)
    geom = bk.BoxGeometry(shape, stoich, 3, cs.form)
    a = bo.propensity_tables(rep.model, shape, dev)
    viol = bo.violation_bits(cs, stoich, shape, dev)
    mask = torch.ones(n, dtype=torch.uint8, device=dev)
    c = rep.model.coefficients(0.0)
    gen = torch.Generator(device=dev).manual_seed(11)
    k9w = None
    for nb in BATCHES:
        P = torch.rand((nb, n), generator=gen, device=dev,
                       dtype=torch.float64)
        rec = k9w_check(dev, smi, f"{BENCH_EDGE}^3 box", c, P, a, geom, bb,
                        mask, viol, SLABS, max_err, library=True,
                        before=K9W_BEFORE_US[("128^3", SLABS, nb)])
        if nb == 3:
            k9w = rec
    del a, viol, mask, geom, P
    torch.cuda.empty_cache()

    # (e) the sensitivity solve over two gloo ranks, box and ELL
    k9w_launches = 0
    ranks = run_ranks(2, "gloo", None, None, target=rank_sens_solve,
                      args=())
    for fsp_backend in ("box", "ell"):
        one = sens_solver(pt, fsp_backend, "krylov", device=dev)
        d1 = one.solve(FD_T_FINAL, FD_TOL)
        if fsp_backend == "box":
            # 11d's small cell: K9w's fixed cost per launch on the final
            # box of this cut, in 2 slabs (no interior: one launch each)
            op = one._operator.base
            c = op.coefficients(FD_T_FINAL)
            k9w_check(dev, smi, f"hog1p_5d_sens t={FD_T_FINAL:g} final "
                      f"{op.shape}", c, one._y.p.view(3, op.geom.n).clone(),
                      op.props, op.geom, op.data().bounds,
                      op.space.mask_bytes(), bo.violation_bits(
                          op.space.constraints, op.stoichiometry, op.shape,
                          dev), 2, max_err, modes=("synth",), library=True)
            del op
        del one
        res = [r[fsp_backend] | {"rank": r["rank"]} for r in ranks]
        r0 = res[0]
        for r in res:
            check(np.array_equal(r["steps"], r0["steps"]),
                  f"11e {fsp_backend}: rank {r['rank']} took other steps")
            check(sum(r["plain"].values()) == 0,
                  f"11e {fsp_backend}: plain versions on CUDA {r['plain']}")
        same = np.array_equal(r0["states"], d1.states)
        check(same, f"11e {fsp_backend}: {r0['states'].shape[0]} states "
                    f"against the one-device solve's {d1.num_states}")
        rel_p = float(np.abs(r0["p"] - d1.p).max() / np.abs(d1.p).max())
        rel_dp = float((np.abs(r0["dp"] - d1.dp).max(axis=1)
                        / np.abs(d1.dp).max(axis=1)).max())
        k9 = sum(r["launches"][k] for r in res for k in bk.MODES
                 if k.startswith("batched_sharded"))
        k4 = sum(r["launches"]["sharded_synth"]
                 + r["launches"]["sharded_mask"] for r in res)
        # per action on each rank: halo exchanges, all-reduces, K9w and K4
        # launches (each column's least and most over the actions)
        acts = np.concatenate([r["per_action"] for r in res])
        lo_hi = [(int(acts[:, k].min()), int(acts[:, k].max()))
                 if acts.size else (0, 0) for k in range(4)]
        print(f"[11e] {fsp_backend}: {acts.shape[0]} sensitivity actions "
              f"over both ranks; per action (least, most): halo exchanges "
              f"{lo_hi[0]}, all-reduces {lo_hi[1]}, K9w launches "
              f"{lo_hi[2]}, K4 launches {lo_hi[3]}", flush=True)
        print(f"[11e] hog1p_5d_sens t={FD_T_FINAL:g} tol={FD_TOL:g} under "
              f"Krylov on {fsp_backend} over 2 gloo ranks: "
              f"{r0['states'].shape[0]} states (the one-device solve's), "
              f"RHS evaluations {r0['rhs']}, K9w launches {k9}, K4 "
              f"{k4} (both ranks), wall "
              + " / ".join(f"{r['wall']:.2f}" for r in res)
              + f" s; p within {rel_p:.3e}, dp within {rel_dp:.3e} of the "
              f"one-device solve (relative, limit 1e-10)", flush=True)
        check(rel_p <= 1e-10 and rel_dp <= 1e-10,
              f"11e {fsp_backend}: p {rel_p:.3e}, dp {rel_dp:.3e}")
        if fsp_backend == "box":
            check(k9 > 0 and k4 > 0, f"11e box: K9w {k9}, K4 {k4}")
            check(acts.shape[0] > 0 and lo_hi[0] == (1, 1)
                  and lo_hi[1] == (1, 1),
                  f"11e box: per action halo exchanges {lo_hi[0]}, "
                  f"all-reduces {lo_hi[1]}, not one each")
            k9w_launches = k9
        else:
            check(k9 + k4 == 0, f"11e ell: box launches {k9 + k4}")
    return (launches["11a"], launches["11b"], k9w_launches, k9w,
            ranks[0]["layout"])


class _FirstReorder(Exception):
    """Ends a phase-12b solve after its first reordered rebuild."""


def layout_kernel_times(dev, smi, label, s, bundle, t, synth, max_err,
                        keep):
    """Phase 12c: the kernel of a box path (K3 where ``synth``, else K1)
    on the path's final capacity in the box's axis order (the solve's own
    operator and p) and in user order (the parent's layout: the same
    capacity transposed, built afresh at the final bounds, p carried
    there by state).  Where both masks hold the same states, dp must be
    bitwise the same by state and the sinks within 1e-12 relative; each
    kernel bitwise its plain version.  CUDA events over 100 calls (the
    plain versions over 3), the bound from ``ops/probes.box_action_bytes``
    over 3.35 TB/s.  Returns {order: (ms, plain ms, bound ms)}, and sets
    ``keep[order]`` to ``(operator, p)`` of each order (phase 14 times the
    ablations on them)."""
    import numpy as np
    import torch
    import pacmensl_tpu_torch as pt
    from pacmensl_tpu_torch.ops import box_kernel as bk
    from pacmensl_tpu_torch.ops import box_operator as bo
    from pacmensl_tpu_torch.ops import probes as pr
    from pacmensl_tpu_torch.statespace.permute import permute_box
    new = s._operator
    S = bundle.model.num_species
    inv = np.argsort(s._current_order())      # user axis i = internal inv[i]
    shape_user = tuple(int(new.shape[int(inv[i])]) for i in range(S))
    cs = pt.ConstraintSet(bundle.constraint, s.constraints.bounds,
                          bundle.expansion_factors, S)
    # seeded with the solve's own states: a BFS from x0 at the final
    # bounds stops at sum(shape) + 1 dilations, short of hog1p_5d's far
    # states, whose paths convert one species into another
    space = pt.BoxStateSpace(
        bundle.model.stoichiometry, cs, bundle.x0, device=dev,
        extent_floor=shape_user, seed_mask_fn=lambda shape: permute_box(
            new.space.mask, new.shape, inv, shape))
    old = bo.BoxOperator(bundle.model, space, synth_mask=synth)
    check(old.synth_mask == synth == new.synth_mask,
          f"12c {label}: kernel modes {old.synth_mask}, {new.synth_mask}")
    c = new.model.coefficients(t)
    p_new = s._y.p
    p_old = permute_box(p_new.view(new.shape), new.shape, inv,
                        space.shape).reshape(-1)
    same_set = torch.equal(
        permute_box(new.space.mask, new.shape, inv, space.shape),
        space.mask)
    out, dps = {}, {}
    for key, op, p in (("user order", old, p_old),
                       ("box order", new, p_new)):
        b = op.data().bounds
        if synth:
            def run(op=op, p=p, b=b):
                return bk.box_action_synth(c, p, op.props, b, op.geom)

            def plain(op=op, p=p, b=b):
                return bk.box_action_synth_reference(c, p, op.props, b,
                                                     op.geom)
        else:
            mask = op.space.mask.reshape(-1).to(torch.uint8)
            viol = bo.violation_bits(op.space.constraints, op.stoichiometry,
                                     op.shape, dev)

            def run(op=op, p=p, mask=mask, viol=viol):
                return bk.box_action(c, p, mask, op.props, viol, op.geom)

            def plain(op=op, p=p, mask=mask, viol=viol):
                return bk.box_action_reference(c, p, mask, op.props, viol,
                                               op.geom)
        got = same_twice(f"12c {label} {key}", run)
        want = plain()
        err = float(max((got[0] - want[0]).abs().max(),
                        (got[1] - want[1]).abs().max()))
        check(torch.equal(got[0], want[0])
              and torch.allclose(got[1], want[1], rtol=1e-12, atol=1e-13),
              f"12c {label} {key}: not its plain version's (max abs "
              f"{err:.3e})")
        mode = "synth" if synth else "mask"
        max_err[mode] = max(max_err[mode], err)
        dps[key] = got
        keep[key] = (op, p)
        ms = [time_ms(run) for _ in range(2)]
        ms_plain = time_ms(plain, reps=3)
        n = op.geom.n
        nbytes = pr.box_action_bytes(
            n, n, op.props.num_reactions, synth, n_valid=op.space.num_states,
            table_bytes=op.props.table_bytes(),
            field_rows=op.props.num_field_rows)
        bms = bound(nbytes, 2 * (2 * op.props.num_reactions + 1) * n)[0]
        lib = (csr_library_ms(f"12c {label} {key}", op, c, p, got, smi)
               if key == "box order" else None)
        out[key] = (min(ms), ms_plain, bms, tuple(op.shape), lib)
        print(f"[12c] {label} {'K3' if synth else 'K1'} in {key} "
              f"{tuple(op.shape)} ({n} elements, {op.space.num_states} "
              f"states, rows of {op.shape[-1]}): "
              + " / ".join(f"{v * 1e3:.1f}" for v in ms)
              + f" us, plain {ms_plain * 1e3:.1f} us, bound {bms * 1e3:.1f} "
              f"us ({nbytes / 1e6:.1f} MB), {bms / min(ms):.3f} of it; "
              f"{smi}", flush=True)
    if same_set:
        dp_t = permute_box(dps["box order"][0].view(new.shape), new.shape,
                           inv, space.shape).reshape(-1)
        rel = float((dps["box order"][1] - dps["user order"][1]).abs().max()
                    / dps["user order"][1].abs().max().clamp_min(1e-300))
        check(torch.equal(dp_t, dps["user order"][0]) and rel <= 1e-12,
              f"12c {label}: the two layouts' dp differ by state "
              f"(sinks {rel:.3e})")
    print(f"[12c] {label}: the same states in both layouts {same_set}"
          + (", dp bitwise by state, sinks within 1e-12" if same_set
             else " (the user-order mask is a fresh BFS)"), flush=True)
    return out


def reorder_carry_check(dev, pt, bundle, sens):
    """Phase 12b: ``bundle`` on the box from its set-up, stopped right
    after its first reordered rebuild; every row of the solution (p, and
    each s_j of a sensitivity solve) must be the old one's by state, bit
    for bit, and zero at the states the rebuild adds.  Returns (t, old
    order, new order, states before and after)."""
    import numpy as np
    base = pt.SensFspSolverMultiSinks if sens else pt.FspSolverMultiSinks
    seen = {}

    class Check(base):
        def _rebuild_box_reordered(self, *args):
            st0, rows0 = self._valid_rows()
            o0 = self._current_order().tolist()
            super()._rebuild_box_reordered(*args)
            st1, rows1 = self._valid_rows()
            at = {tuple(x): i for i, x in enumerate(st1)}
            idx = np.array([at.get(tuple(x), -1) for x in st0])
            rest = np.setdiff1d(np.arange(len(st1)), idx)
            seen.update(t=self._t_now, old=o0,
                        new=self._current_order().tolist(), n0=len(st0),
                        n1=len(st1), rows=rows0.shape[0],
                        carried=bool((idx >= 0).all()
                                     and np.array_equal(rows1[:, idx], rows0)
                                     and not rows1[:, rest].any()))
            raise _FirstReorder

    s = Check(backend="box", device=dev)
    s.set_model(bundle.model)
    s.set_constraint_functions(bundle.constraint)
    s.set_initial_bounds(bundle.bounds)
    s.set_expansion_factors(bundle.expansion_factors)
    s.set_initial_distribution(bundle.x0, bundle.p0)
    try:
        s.solve(HOG_T_FINAL, HOG_TOL)
    except _FirstReorder:
        pass
    check(bool(seen), f"12b {bundle.name}: no reordered rebuild")
    print(f"[12b] {bundle.name}{' (sensitivities)' if sens else ''}: at t = "
          f"{seen['t']:.6g} the order {seen['old']} became {seen['new']}; "
          f"{seen['n0']} states before, {seen['n1']} after; every one of "
          f"the {seen['rows']} rows carried bitwise by state (new states "
          f"0): {seen['carried']}", flush=True)
    check(seen["carried"], f"12b {bundle.name}: a row was not carried "
                           "bitwise by state")
    return seen


def layout_phase(dev, smi, run_solve, layouts, k12, halo12, wall5, d5,
                 mass_tol):
    """Phase 12, the box's axis order and eager capacity: (a) each box
    path's axis orders and reordered rebuilds, (b) a reordered rebuild
    carries p and every s_j bitwise by state, (c) the kernel times of
    each order (measured at phases 4-6), (d) 11e's halo per matvec and
    per vector, (e) hog1p_5d with ``preallocate=True`` against phase 5's
    solve on the capacity ladder (``wall5``, ``d5``).  Returns the
    launches of (e)'s solve."""
    import torch
    import pacmensl_tpu_torch as pt
    for key, (orders, n, sec, cap) in layouts.items():
        if key.split()[0] in ("4", "5", "6", "9"):
            print(f"[12a] {key}: axis orders {orders}, reordered rebuilds "
                  f"{n} in {sec:.3f} s, final capacity {cap}", flush=True)
    reorder_carry_check(dev, pt, pt.models.hog1p_5d(), False)
    reorder_carry_check(dev, pt, pt.models.hog1p_5d_sens(), True)
    torch.cuda.empty_cache()
    for label, per in k12.items():
        u, b = per["user order"], per["box order"]
        print(f"[12c] {label}: user order {u[3]} {u[0] * 1e3:.1f} us "
              f"(bound {u[2] * 1e3:.1f}), box order {b[3]} "
              f"{b[0] * 1e3:.1f} us (bound {b[2] * 1e3:.1f}, library "
              f"{b[4] * 1e3:.1f}, the lesser reading; kernel / library "
              f"{b[0] / b[4]:.3f}, the kernel "
              f"{'faster' if b[0] < b[4] else 'slower'}); "
              f"box / user {b[0] / u[0]:.3f}; {smi}", flush=True)
    print(f"[12d] 11e's box over 2 ranks: axis orders {halo12['orders']}, "
          f"final capacity {halo12['capacity']}, w0 {halo12['w0']}, plane "
          f"{halo12['plane']} values; halo values per matvec (both "
          f"boundaries' planes, one vector) {halo12['per_matvec']}, per "
          f"rank, neighbour and vector {halo12['per_rank']}, per K9w "
          f"exchange of "
          f"nb = 3 vectors {3 * halo12['per_matvec']}", flush=True)
    bundle = pt.models.hog1p_5d()
    s = pt.FspSolverMultiSinks(backend="box", device=dev, preallocate=True)
    s.set_model(bundle.model)
    s.set_constraint_functions(bundle.constraint)
    s.set_initial_bounds(bundle.bounds)
    s.set_expansion_factors(bundle.expansion_factors)
    s.set_initial_distribution(bundle.x0, bundle.p0)
    d, launches, wall = run_solve(
        12, f"hog1p_5d t={HOG_T_FINAL:g} preallocate=True", s, HOG_T_FINAL,
        HOG_TOL, mass_tol)
    check(s._space.prealloc_budget is not None,
          "12e hog1p_5d: not on eager capacity")
    l1 = l1_by_state(d, d5)
    print(f"[12e] hog1p_5d: eager capacity {tuple(s._space.shape)} "
          f"(budget {s._space.prealloc_budget:.4g} elements), wall "
          f"{wall:.2f} s against the ladder's {wall5:.2f} s (phase 5), "
          f"ratio {wall / wall5:.3f}; {d.num_states} states, L1 to the "
          f"ladder's {l1:.3e} (limit {2 * HOG_TOL:g}); {smi}", flush=True)
    check(l1 <= 2 * HOG_TOL, f"12e hog1p_5d: L1 to the ladder {l1:.3e}")
    del s, d
    torch.cuda.empty_cache()
    return launches


def entry_phase(dev, smi, run_entry, final_operator, rep, d4, d6,
                mass_tol):
    """Phase 13, the port's entry points at full width: (a) the
    repressilator example's stages 2-4 from phase 4's distribution, (b)
    transcr_reg_6d to the example's t = 300 with the fill rule's move to
    ELL, (c) the scaling sweep at SWEEP_BOUND over one NCCL rank per card,
    (d) the dry run's entry and multi-rank run, (e) the flagship's command
    line.  Returns the box kernel's launches of (a)-(d) by mode."""
    import numpy as np
    import torch
    import pacmensl_tpu_torch as pt
    from pacmensl_tpu_torch.examples import repressilator as ex_rep
    from pacmensl_tpu_torch.examples import scaling_sweep
    from pacmensl_tpu_torch.examples import transcr_reg_6d as ex_tr6
    from pacmensl_tpu_torch.examples import common
    from pacmensl_tpu_torch.fsp import solver as fsp_solver
    from pacmensl_tpu_torch.ops import box_kernel as bk
    from pacmensl_tpu_torch.ops import probes as pr
    from pacmensl_tpu_torch.tools import dryrun
    no_opts = pt.Options()

    # (a) the repressilator's other three stages
    t0 = time.perf_counter()
    dists, launch13a = {"adaptive_custom": d4}, []
    for name in ex_rep.STAGES[1:]:
        adaptive = dists.get(name.replace("fixed", "adaptive"))
        args = ex_rep.stage_args(name, rep, adaptive)
        s, d, launch, wall = run_entry(
            "13a", f"repressilator {name} t={SLICE_T_FINAL:g} "
                   f"tol={SLICE_TOL:g}",
            lambda: ex_rep.run_stage(name, rep, *args, no_opts,
                                     SLICE_T_FINAL, SLICE_TOL, str(OUT_DIR),
                                     dev),
            SLICE_TOL, lambda k: 1.0e-8)
        launch13a.append(launch)
        dists[name] = d
        cap = (tuple(s._space.shape) if s._backend_used == "box"
               else f"ELL n_pad {s._operator.n_pad}")
        epochs = s.get_event_log().events["ODESolve"].count
        print(f"[13a] {name}: {d.num_states} states, bounds "
              f"{d.bounds.tolist()}, capacity {cap}, epochs {epochs}, "
              f"launches {launch}, wall {wall:.2f} s; {smi}", flush=True)
        if name.startswith("fixed"):
            l1 = l1_by_state(d, adaptive)
            print(f"[13a] {name}: L1 to its adaptive stage {l1:.3e} "
                  f"(limit {2 * SLICE_TOL:g}); bounds unchanged: "
                  f"{np.array_equal(d.bounds, adaptive.bounds)}", flush=True)
            check(np.array_equal(d.bounds, adaptive.bounds),
                  f"13a {name}: expanded from {adaptive.bounds.tolist()} "
                  f"to {d.bounds.tolist()}")
            check(l1 <= 2 * SLICE_TOL, f"13a {name}: L1 to its adaptive "
                                       f"stage {l1:.3e}")
        del s
        torch.cuda.empty_cache()
    l1 = l1_by_state(dists["adaptive_custom"], dists["adaptive_hyperrec"])
    print(f"[13a] the two adaptive stages: L1 {l1:.3e} (limit "
          f"{2 * SLICE_TOL:g}); phase 13a {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(l1 <= 2 * SLICE_TOL, f"13a: the adaptive stages differ by "
                               f"{l1:.3e}")

    # (b) transcr_reg_6d to t = 300: K1 on the box, then the fill rule
    t0 = time.perf_counter()
    mig = {}
    cls = pt.FspSolverMultiSinks
    migrate = cls._migrate_box_to_ell

    def hooked(s):
        op, t = s._operator, s._t_now
        S = s.model.num_species
        tight = float(np.prod(s.constraints.derive_box_bounds(
            S, s._init_int) + 1.0))
        mig.update(t=t, states=s.num_states, fill=s.num_states / tight,
                   capacity=tuple(op.shape), k1=dict(bk.KERNEL.launches),
                   dist=s._make_distribution())
        uncounted(lambda: final_operator(
            "13b", "transcr_reg_6d, last box epoch before the migration",
            s, t, synth=False))
        c = op.model.coefficients(t)
        want = uncounted(lambda: op.action(t, pt.FspVector(p=s._y.p,
                                                           sinks=None), c=c))
        mig["library_ms"] = csr_library_ms(
            "13b K1 at the last box", op, c, s._y.p, (want.p, want.sinks),
            smi)
        mig["k1_ms"] = uncounted(lambda: min(time_ms(
            lambda: op.action(t, pt.FspVector(p=s._y.p, sinks=None), c=c))
            for _ in range(2)))
        n = op.geom.n
        nbytes = pr.box_action_bytes(
            n, n, op.props.num_reactions, False, n_valid=s.num_states,
            table_bytes=op.props.table_bytes(),
            field_rows=op.props.num_field_rows)
        mig["bound_ms"] = bound(
            nbytes, 2 * (2 * op.props.num_reactions + 1) * n)[0]
        t1 = time.perf_counter()
        migrate(s)
        torch.cuda.synchronize()
        mig["seconds"] = time.perf_counter() - t1
    cls._migrate_box_to_ell = hooked
    try:
        s, d, launch13b, wall = run_entry(
            "13b", f"transcr_reg_6d t={TR6_EXAMPLE_T:g} tol={TR6_TOL:g}",
            lambda: ex_tr6.main(["-device", "cuda", "-out_dir",
                                 str(OUT_DIR)]), TR6_TOL, mass_tol)
    finally:
        cls._migrate_box_to_ell = migrate
    check(isinstance(s._ode_solver, pt.BdfSolver),
          "13b: transcr_reg_6d did not run BDF")
    check(launch13b["mask"] > 0, "13b: no K1 launch")
    if mig:
        print(f"[13b] migrated to ELL at t = {mig['t']:.4g} with "
              f"{mig['states']} states (fill {mig['fill']:.4f} of the "
              f"tight box, floor {fsp_solver.BOX_FILL_FLOOR}), capacity "
              f"{mig['capacity']}, after {mig['k1']['mask']} K1 launches; "
              f"the migration {mig['seconds']:.2f} s; K1 on the last box "
              f"{mig['k1_ms'] * 1e3:.1f} us, bound "
              f"{mig['bound_ms'] * 1e3:.1f} us, library (the lesser "
              f"reading) {mig['library_ms'] * 1e3:.1f} us; {smi}",
              flush=True)
    else:
        S = s.model.num_species
        tight = float(np.prod(s.constraints.derive_box_bounds(
            S, s._init_int) + 1.0))
        print(f"[13b] no migration: the solve ended on the box with "
              f"{s.num_states} states, fill {s.num_states / tight:.4f} of "
              f"the tight box (floor {fsp_solver.BOX_FILL_FLOOR})", flush=True)
    print(f"[13b] transcr_reg_6d t={TR6_EXAMPLE_T:g}: {d.num_states} states, "
          f"bounds {d.bounds.tolist()}, backend {s._backend_used}, wall "
          f"{wall:.2f} s (the TPU's float32 record, context only: "
          f"{TR6_TPU_STATES} states, bounds {TR6_TPU_BOUNDS})", flush=True)
    if s._backend_used == "ell":
        op, y = s._operator, s._y
        n = op.n_states
        c = op.model.coefficients(TR6_EXAMPLE_T)
        A = ell_csr(op, c)
        ref = torch.mv(A, y.p[:n].contiguous())
        got = op.action(TR6_EXAMPLE_T, y)
        e_dp = float((got.p[:n] - ref[:n]).abs().max()) \
            / float(ref[:n].abs().max())
        e_s = float(((got.sinks - ref[n:]).abs()
                     / ref[n:].abs().clamp_min(1e-300)).max())
        print(f"[13b] ELL action at {n} states against one torch.mv of the "
              f"CSR generator: dp {e_dp:.3e}, sinks {e_s:.3e} relative "
              f"(limits 1e-12)", flush=True)
        check(e_dp <= 1e-12 and e_s <= 1e-12,
              f"13b: the ELL action differs from the CSR product "
              f"({e_dp:.3e}, {e_s:.3e})")
        del A, ref, got, op, y
    del s
    torch.cuda.empty_cache()
    # an independent solve on ELL from the start, reduced to the time of
    # the migration (to phase 6's t = 30 without one)
    t_cmp, want = ((mig["t"], mig["dist"]) if mig else (TR6_T_FINAL, d6))
    tr6 = pt.models.transcription_regulation_6d()
    s2 = common.configure(pt.FspSolverMultiSinks(
        backend="ell", odes_type="cvode", device=dev), tr6, no_opts,
        constraint=None)
    d2, wall2 = common.timed_solve(s2, t_cmp, TR6_TOL)
    l1 = l1_by_state(d2, want)
    print(f"[13b] ELL from the start to t = {t_cmp:.4g}: {d2.num_states} "
          f"states, {wall2:.2f} s; L1 to the box solve there {l1:.3e} "
          f"(limit {2 * TR6_TOL:g}); phase 13b "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(l1 <= 2 * TR6_TOL, f"13b: L1 to the ELL solve {l1:.3e}")
    del s2, d2
    torch.cuda.empty_cache()

    # (c) the scaling sweep, one NCCL rank per card
    t0 = time.perf_counter()
    sweep = scaling_sweep.main(["-bound", str(SWEEP_BOUND), "-device",
                                "cuda"])
    for r in sweep["rows"]:
        if r["path"] == "box":
            check(r["same"] and r["sinks_rel"] <= 1e-12,
                  f"13c: the box dp over {r['n']} ranks is not one "
                  f"card's (sinks {r['sinks_rel']:.3e})")
        else:
            check(r["rel_err"] <= 1e-12,
                  f"13c: the ELL dp over {r['n']} ranks ({r['label']}) "
                  f"differs from one card's by {r['rel_err']:.3e}")
    launch13c = sweep["launches"]
    print(f"[13c] sweep at {SWEEP_BOUND + 1}^3 over up to "
          f"{torch.cuda.device_count()} cards: {len(sweep['rows'])} rows, "
          f"box dp bitwise one card's and ELL within 1e-12 on every n; "
          f"launches {launch13c}; phase 13c {time.perf_counter() - t0:.1f} "
          f"s; {smi}", flush=True)

    # (d) the dry run: entry() once on the card, then the multi-rank run
    t0 = time.perf_counter()
    fn, args = dryrun.entry(dev)
    torch.cuda.synchronize()
    bk.KERNEL.reset_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    launch13d = dict(bk.KERNEL.launches)
    mass = float(out.p.sum() + out.sinks.sum())
    print(f"[13d] entry(): one action on {tuple(out.p.shape)}, launches "
          f"{launch13d}, sum(dp) + sum(sinks) = {mass:.3e}", flush=True)
    check(launch13d["synth"] == 1 and sum(launch13d.values()) == 1,
          f"13d: entry() launched {launch13d}")
    check(bool(torch.isfinite(out.p).all()) and abs(mass) <= 1e-12,
          f"13d: entry()'s action is not finite or does not conserve mass "
          f"({mass:.3e})")
    ranks = dryrun.dryrun_multichip(torch.cuda.device_count(), "cuda")
    for r in ranks:
        print(f"[13d] dry run rank {r['rank']} ({r['device']}): mass "
              f"{r['mass']:.12f} at t = {r['t']:g}, box {r['box_capacity']}, "
              f"Poisson {r['poisson_epochs']} epochs, {r['poisson_states']} "
              f"states, L1 {r['poisson_l1']:.3e}, launches {r['launches']}",
              flush=True)
    launch13d = add_launches(launch13d, *(r["launches"] for r in ranks))
    check(launch13d["sharded_synth"] + launch13d["sharded_mask"] > 0,
          "13d: the dry run launched no K4")
    print(f"[13d] phase 13d {time.perf_counter() - t0:.1f} s", flush=True)

    # (e) the flagship's command line
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "pacmensl_tpu_torch.tools.flagship",
         "-repeat", "2"], capture_output=True, text=True,
        cwd=str(Path(__file__).resolve().parent), timeout=600)
    lines = res.stdout.strip().splitlines()
    check(res.returncode == 0 and lines and lines[-1].startswith("walls:"),
          f"13e: the flagship exited with {res.returncode}: "
          f"{res.stderr[-2000:]}")
    walls = [float(w) for w in lines[-1].split()[1:]]
    check(len(walls) == 2, f"13e: {lines[-1]}")
    print(f"[13e] python -m pacmensl_tpu_torch.tools.flagship -repeat 2: "
          + " | ".join(ln for ln in lines if ln.startswith("==="))
          + f"; {lines[-1]} s; the command {time.perf_counter() - t0:.1f} "
          f"s; {smi}", flush=True)
    return add_launches(*launch13a), launch13b, launch13c, launch13d


def ablation_phase(smi, cases):
    """Phase 14: the box kernel's ablation and fixed-cost probes
    (``tools/kernel_ablate.py``, ``tools/base_probe.py``) at their default
    box (128^3, through their command lines) and on ``cases``
    (``kernel_ablate.Case``, held on the host; each goes to the card for
    its own turn) of phases 4-6's final operators.  Every
    variant and switch build is checked against its plain version before
    it is timed; a mismatch raises.  Returns ``{label: (ablation,
    probe)}``."""
    import torch
    from pacmensl_tpu_torch.tools import base_probe
    from pacmensl_tpu_torch.tools import kernel_ablate as ka

    def out(line):
        print(f"[14] {line}", flush=True)
    res = {f"{BENCH_EDGE}^3": (ka.main([], out=out),
                               base_probe.main([], out=out))}
    torch.cuda.empty_cache()
    for case in cases:
        case = case.to(torch.device("cuda", 0))
        res[case.label] = (ka.ablate(case, smi, out=out),
                           base_probe.device_side(case, smi, out=out))
        del case
        torch.cuda.empty_cache()
    return res


def bdf_step_phase(dev, smi):
    """Phase 15: the fused passes of a BDF step against their PyTorch
    versions, bitwise, at both shapes and every order, the flags, and the
    passes timed at the stacked vector; returns the ``kernels`` entry."""
    import statistics

    import torch
    from pacmensl_tpu_torch.ops import bdf_step as bs
    from pacmensl_tpu_torch.ops import vecops as vo
    from pacmensl_tpu_torch.solvers import bdf

    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    solver = bdf.BdfSolver(lambda t, v: v)
    err = [0.0]

    def random(n, nc, scale=1.0):
        """Normal entries times ``scale``, a tenth of them +0 and a tenth
        -0, as a box vector's masked states and small differences give."""
        def part(m):
            x = torch.randn(m, dtype=torch.float64, device=dev,
                            generator=gen) * scale
            u = torch.rand(m, device=dev, generator=gen)
            x[u < 0.1] = 0.0
            x[(u >= 0.1) & (u < 0.2)] = -0.0
            return x
        return vo.FspVector(p=part(n), sinks=part(nc))

    def same(label, got, want):
        """Bitwise (the int64 views, so -0 against +0 counts)."""
        for g, w in zip(got, want):
            e = float((g - w).abs().max()) if g.numel() else 0.0
            err[0] = max(err[0], e)
            check(torch.equal(g.view(torch.int64), w.view(torch.int64)),
                  f"15 {label}: not bitwise the PyTorch operations' (max "
                  f"abs {e:.3e})")

    def passes(D, q, a, d, S, out, flags):
        """Each pass at order q against its PyTorch version; returns the
        plain (y_pred, psi)."""
        y = bs.predict(D, q, bdf._PSI[q], S, flags[1:])
        y_pred, psi = bdf.BdfSolver._predict(D, q)
        same(f"predict q={q}", y, y_pred)
        same(f"predict q={q} psi", S, psi)
        check(flags[1:].tolist() == [1.0, 1.0], f"15 predict q={q}: flags "
                                                f"{flags[1:].tolist()}")
        del y
        c = float(0.37 / bdf._ALPHA[q])
        same(f"rhs q={q}", bs.rhs(a, psi, c, flags[1]),
             vo.sub(vo.scale(c, a), psi))
        errc = float(bdf._ERRC[q])
        y_new = bs.post(y_pred, d, errc, solver.atol, solver.rtol, out, S,
                        flags[2])
        e = vo.scale(errc, d)
        same(f"post q={q} y_new", y_new, vo.add(y_pred, d))
        same(f"post q={q} terms", S, vo.FspVector(
            p=solver._err_terms(e.p, y_pred.p),
            sinks=solver._err_terms(e.sinks, y_pred.sinks)))
        solver._rms(S, out=flags[0])
        same(f"post q={q} norm", [flags[:1]],
             [solver._err_norm_dev(e, y_pred).reshape(1)])
        check(flags[1:].tolist() == [1.0, 1.0], f"15 post q={q}: flags "
                                                f"{flags[1:].tolist()}")
        del e, y_new
        rows = slice(0, q + 3)
        keep = (D.p[rows].clone(), D.sinks[rows].clone())
        bdf.BdfSolver._update_D(D, q, d)
        want = (D.p[rows].clone(), D.sinks[rows].clone())
        D.p[rows].copy_(keep[0])
        D.sinks[rows].copy_(keep[1])
        bs.update(D, q, d)
        same(f"update q={q}", (D.p[rows], D.sinks[rows]), want)
        D.p[rows].copy_(keep[0])
        D.sinks[rows].copy_(keep[1])
        return y_pred, psi

    t0 = time.perf_counter()
    for name, (n, nc) in BDF_SHAPES.items():
        D = vo.basis_empty(vo.FspVector(
            p=torch.empty(n, dtype=torch.float64, device=dev),
            sinks=torch.empty(nc, dtype=torch.float64, device=dev)), bdf.ND)
        for j in range(bdf.ND):
            vo.basis_set(D, j, random(n, nc, 10.0 ** -j))
        a, d = random(n, nc), random(n, nc, 1e-4)
        S, out = (vo.FspVector(p=torch.empty_like(d.p),
                               sinks=torch.empty_like(d.sinks))
                  for _ in range(2))
        flags = torch.zeros(3, dtype=torch.float64, device=dev)
        for q in range(1, bdf.MAX_ORDER + 1):
            passes(D, q, a, d, S, out, flags)
        print(f"[15] {name} ({n} elements, {nc} sinks): predict, rhs, post "
              f"and update at q = 1..{bdf.MAX_ORDER} bitwise their PyTorch "
              f"versions", flush=True)
        if name != BDF_TIMED:
            del D, a, d, S, out
            torch.cuda.empty_cache()
    # a NaN and an Inf in the action (so the right-hand side) and in d
    # (so the new state), in either part: the flag vecops.isfinite clears
    n, nc = 1000003, 7
    Ds = vo.basis_empty(random(n, nc), bdf.ND)
    for j in range(bdf.ND):
        vo.basis_set(Ds, j, random(n, nc, 10.0 ** -j))
    fl = torch.zeros(3, dtype=torch.float64, device=dev)
    for where in ("p", "sinks"):
        for bad in (float("nan"), float("inf")):
            for planted in ("rhs", "y_new"):
                a1, d1 = random(n, nc), random(n, nc, 1e-4)
                getattr(a1 if planted == "rhs" else d1, where)[
                    n // 3 if where == "p" else 2] = bad
                S1 = vo.FspVector(p=torch.empty_like(a1.p),
                                  sinks=torch.empty_like(a1.sinks))
                y1 = bs.predict(Ds, 2, bdf._PSI[2], S1, fl[1:])
                r1 = bs.rhs(a1, S1, 0.5, fl[1])
                want = [bool(vo.isfinite(vo.sub(vo.scale(0.5, a1), S1))),
                        bool(vo.isfinite(vo.add(y1, d1)))]
                bs.post(y1, d1, 0.25, 1e-14, 1e-6, r1, S1, fl[2])
                got = [v == 1.0 for v in fl[1:].tolist()]
                check(got == want == [planted != "rhs", planted != "y_new"],
                      f"15 flags: {bad} in {planted}'s {where}: {got}, "
                      f"vecops.isfinite {want}")
    del Ds, a1, d1, S1, y1, r1
    print(f"[15] a NaN and an Inf in either part of the action or of d: "
          f"the flags are vecops.isfinite's; checks "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # each pass alone at the stacked vector, order BDF_TIMED_Q, beside its
    # PyTorch operations; the compulsory bytes: each vector read and each
    # written once (predict q + 3, rhs 3, post 4, update 2q + 6)
    q = BDF_TIMED_Q
    n, nc = BDF_SHAPES[BDF_TIMED]
    y_pred, psi = bdf.BdfSolver._predict(D, q)
    c, errc = float(0.37 / bdf._ALPHA[q]), float(bdf._ERRC[q])

    def plain_post():
        e = vo.scale(errc, d)
        return vo.add(y_pred, d), vo.FspVector(
            p=solver._err_terms(e.p, y_pred.p),
            sinks=solver._err_terms(e.sinks, y_pred.sinks))
    cases = [
        ("predict", q + 3, 3 * q - 1,
         lambda: bs.predict(D, q, bdf._PSI[q], S, flags[1:]),
         lambda: bdf.BdfSolver._predict(D, q)),
        ("rhs", 3, 2, lambda: bs.rhs(a, psi, c, flags[1]),
         lambda: vo.sub(vo.scale(c, a), psi)),
        ("post", 4, 6, lambda: bs.post(y_pred, d, errc, solver.atol,
                                       solver.rtol, out, S, flags[2]),
         plain_post),
        # the timed updates change D's values, not the bytes they move
        ("update", 2 * q + 6, q + 2, lambda: bs.update(D, q, d),
         lambda: bdf.BdfSolver._update_D(D, q, d))]
    per = 8 * (n + nc)
    total = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0}
    for label, vectors, ops, run, plain in cases:
        fused = [time_ms(run, reps=20) for _ in range(3)]
        ref = [time_ms(plain, reps=20) for _ in range(3)]
        ms, ref_ms = statistics.median(fused), statistics.median(ref)
        b_ms, by = bound(vectors * per, ops * (n + nc))
        total["ms"] += ms
        total["plain_ms"] += ref_ms
        total["bytes"] += vectors * per
        total["flops"] += ops * (n + nc)
        print(f"[15] {label} q={q} at {BDF_TIMED} ({n} elements): "
              + " / ".join(f"{v * 1e3:.1f}" for v in fused) + " us, bound "
              f"{b_ms * 1e3:.1f} us ({vectors} vectors, by {by}), "
              f"{100 * b_ms / ms:.1f}% of {HBM_RATE / 1e12:.2f} TB/s; "
              f"PyTorch operations " + " / ".join(f"{v * 1e3:.1f}"
                                                  for v in ref)
              + f" us; {smi}", flush=True)
    b_ms, by = bound(total["bytes"], total["flops"])
    print(f"[15] one step's passes at q={q}: {total['ms'] * 1e3:.1f} us, "
          f"bound {b_ms * 1e3:.1f} us, {100 * b_ms / total['ms']:.1f}%; "
          f"PyTorch operations {total['plain_ms'] * 1e3:.1f} us", flush=True)
    del D, a, d, S, out, y_pred, psi
    torch.cuda.empty_cache()
    return {"name": "bdf_step", "route": "cuda",
            "source": "pacmensl_tpu_torch/csrc/bdf_step.cu",
            "replaces": "pacmensl_tpu/solvers/bdf.py:226",
            "max_abs_err": err[0], "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": b_ms,
            "bound_by": by, "library_ms": None}


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    t_start = time.perf_counter()

    def clock(phase):
        """The script's seconds so far (its limit is 1200, the build
        included)."""
        print(f"[clock] phase {phase} starts at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import pacmensl_tpu_torch as pt
    from pacmensl_tpu_torch.examples import repressilator as ex_rep
    from pacmensl_tpu_torch.ops import box_kernel as bk
    from pacmensl_tpu_torch.ops import box_operator as bo
    from pacmensl_tpu_torch.tools import base_probe, bench_configs
    from pacmensl_tpu_torch.tools import kernel_ablate as ka
    dev = torch.device("cuda", 0)

    # ---------------------------------------------------------- phase 1
    clock(1)
    smi = card()
    print(f"[1] card: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    # every library of the port at once, one nvcc each: the two ablation
    # builds of the box kernel (phase 14) too
    from concurrent.futures import ThreadPoolExecutor
    from pacmensl_tpu_torch.ops import ablation
    from pacmensl_tpu_torch.ops import bdf_step as bs
    from pacmensl_tpu_torch.ops import probes as pr
    from pacmensl_tpu_torch.ops.cuda_build import NVCC_FLAGS
    t0 = time.perf_counter()
    libs = {"box kernel": bk.KERNEL, "probe kernels": pr.PROBES,
            "box kernel, no-tail build": ablation.NO_TAIL,
            "box kernel, zero-coords build": ablation.ZERO_COORDS,
            "BDF step passes": bs.KERNELS}
    with ThreadPoolExecutor(len(libs)) as ex:
        for f in [ex.submit(lib.load) for lib in libs.values()]:
            f.result()
    for name, lib in libs.items():
        print(f"[1] {name}: built in {lib.build_seconds:.2f} s -> "
              f"{lib.path.name}", flush=True)
        if lib.build_log and lib.flags == NVCC_FLAGS:
            print(lib.build_log, file=sys.stderr, flush=True)
    print(f"[1] all {len(libs)} loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for line in ptxas_lines(bk.KERNEL.build_log):
        print(f"[1] ptxas, box kernel {line}", flush=True)

    # ---------------------------------------------------------- phase 2
    clock(2)
    rng = np.random.default_rng(1234)
    max_err = {"mask": 0.0, "synth": 0.0, "sharded": 0.0, "batched": 0.0,
               "batched_sharded": 0.0}
    TOL = dict(rtol=1e-12, atol=1e-13)

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

    def library(label, c, p, mask, a, viol, shape, nc, k1, reps=100,
                stoich=None):
        """The generator as CSR on ``p`` in both readings of
        :func:`library_readings`, checked against K1's (dp, sinks)
        ``k1``; the least, ms per call over ``reps`` calls.
        ``stoich``: the operator's (default: the repressilator's in user
        order)."""
        A = generator_csr(c, mask, a.dense(), viol, shape,
                          rep.model.stoichiometry if stoich is None
                          else stoich, nc)
        r = library_readings(label, A, nc, p, k1, reps)
        print(f"[{label}] library ({A.shape[0]} x {A.shape[1]}, "
              f"{A.values().numel()} nonzeros): " + readings_text(r),
              flush=True)
        del A
        return min(r.values())

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

    host, parts, size = base_probe.host_side(host_op)
    print("[2] " + base_probe.host_side_text(host_op, host, parts, size)
          .replace("\n", "\n[2] "), flush=True)
    del k1, run
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 3
    clock(3)
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
    clock(4)
    #: phase 12a: per solve (its phase and label) the box's axis orders,
    #: reordered rebuilds and their seconds, and the final capacity
    layouts = {}
    #: phase 12c: the kernel's times on each path's final capacity in
    #: both axis orders
    k12 = {}

    def solver_for(bundle, odes_type, preallocate="auto"):
        s = pt.FspSolverMultiSinks(backend="box", odes_type=odes_type,
                                   device=dev, preallocate=preallocate)
        s.set_model(bundle.model)
        s.set_constraint_functions(bundle.constraint)
        s.set_initial_bounds(bundle.bounds)
        s.set_expansion_factors(bundle.expansion_factors)
        s.set_initial_distribution(bundle.x0, bundle.p0)
        return s

    #: the fused BDF step's launches in every solve of run_entry, by pass
    bdf_launches = dict.fromkeys(bs.NAMES, 0)

    def run_entry(phase, label, go, tol, mass_tol, kernel=True,
                  neg_tol=lambda steps: 1.0e-12):
        """One solve through an entry point, ``go()`` returning
        ``(solver, distribution, wall)``, with the counters set to 0 just
        before it; prints and checks its output and the fused BDF step's
        launches (adding them to ``bdf_launches``); returns (solver,
        distribution, launches, wall).  ``kernel=False``: a
        compressed-backend solve, which launches no box kernel.
        ``neg_tol(steps)``: how far below 0 an entry of p may lie after
        that many accepted steps."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        bk.KERNEL.reset_counts()
        bs.KERNELS.reset_counts()
        s, d, wall = go()
        torch.cuda.synchronize()
        launches = dict(bk.KERNEL.launches)
        fused = dict(bs.KERNELS.launches)
        plain = dict(bk.KERNEL.plain_cuda_calls)
        peak = torch.cuda.max_memory_allocated(dev)
        ev = s.get_event_log().events
        mass, sinks = d.sum(), np.asarray(d.sinks)
        steps = ev["ODESteps"].count if "ODESteps" in ev else 0
        rej = ev["ODEStepsRejected"].count if "ODEStepsRejected" in ev else 0
        cap = (tuple(s._space.shape) if s._backend_used == "box"
               else f"n_pad {s._operator.local_n}")
        reo = ev.get("BoxReorder")
        layouts[f"{phase} {label}"] = (list(s.axis_orders_),
                                       reo.count if reo else 0,
                                       reo.total_s if reo else 0.0, cap)
        print(f"[{phase}] {label}: {d.num_states} states, bounds "
              f"{d.bounds.tolist()}, capacity {cap}, "
              f"epochs {ev['ODESolve'].count}, RHS evaluations "
              f"{ev['RHSEvaluation'].count}, steps {steps}, rejected {rej}, "
              f"wall {wall:.2f} s, peak device memory {peak / 2**30:.2f} "
              f"GiB ({held / 2**30:.2f} held before the solve), sum(p) "
              f"{mass:.10f}, sum(sinks) {sinks.sum():.3e}, "
              f"kernel launches {launches}, plain calls on CUDA {plain}",
              flush=True)
        print(f"[{phase}] {label}: box axis orders (t at the rebuild, "
              f"order) {s.axis_orders_}, reordered rebuilds "
              f"{layouts[f'{phase} {label}'][1]} in "
              f"{layouts[f'{phase} {label}'][2]:.3f} s", flush=True)
        print(s.get_event_log().report(), flush=True)
        check(np.isfinite(d.p).all() and np.isfinite(sinks).all(),
              f"{label}: non-finite solution")
        nt = neg_tol(steps)
        check(d.p.min() > -nt, f"{label}: negative probability "
                               f"{d.p.min():.3e} (limit {-nt:.1e})")
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
        check((sum(launches.values()) > 0) == kernel,
              f"{label}: kernel launches {launches}")
        # BDF on the card takes the fused passes on every attempt (one
        # error-norm read each): predict, rhs and post once per attempt,
        # update once per accepted step; any other integrator none
        attempts = (ev["HostSync.BDFErrorNorm"].count
                    if "HostSync.BDFErrorNorm" in ev else 0)
        n_fused = ev["BDFFusedStep"].count if "BDFFusedStep" in ev else 0
        print(f"[{phase}] {label}: BDF attempts {attempts}, BDFFusedStep "
              f"{n_fused}, fused step launches {fused}", flush=True)
        check(fused["predict"] == fused["rhs"] == fused["post"] == attempts
              == n_fused and fused["update"] == (steps if attempts else 0),
              f"{label}: fused step launches {fused} against {attempts} "
              f"attempts, {n_fused} BDFFusedStep, {steps} steps")
        for k, v in fused.items():
            bdf_launches[k] += v
        check(sum(plain.values()) == 0,
              f"{label}: the plain versions ran {plain} times on CUDA")
        return s, d, launches, wall

    def run_solve(phase, label, s, t_final, tol, mass_tol, **kw):
        """``run_entry`` of ``s.solve(t_final, tol)``; returns
        (distribution, launches, wall)."""
        def go():
            t0 = time.perf_counter()
            d = s.solve(t_final, tol)
            torch.cuda.synchronize()
            return s, d, time.perf_counter() - t0
        return run_entry(phase, label, go, tol, mass_tol, **kw)[1:]

    def final_operator(phase, label, s, t, synth=True):
        """Every mode that applies against its plain version on the final
        operator and solution; the final operator's mode must be
        ``synth``."""
        op = s._operator
        check(op.synth_mask == synth,
              f"{label}: the final operator does not use the "
              f"{'synthesized-mask' if synth else 'mask-reading'} kernel")
        compare(phase, f"{label}: final operator and p", op, t, p=s._y.p)

    # phase 4: repressilator, Krylov, through the example's first stage.
    # Phases 4, 5 and 9 hold the box's kernels, so they pass the option
    # -fsp_backend box: under the default "auto" the fill rule moves the
    # repressilator to ELL partway (PERF.md, the entry points' findings)
    box_opts = pt.Options.from_argv(["-fsp_backend", "box"])
    s, d4, launch4, _ = run_entry(
        4, f"repressilator t={SLICE_T_FINAL:g} tol={SLICE_TOL:g}",
        lambda: ex_rep.run_stage(
            "adaptive_custom", rep,
            *ex_rep.stage_args("adaptive_custom", rep), box_opts,
            SLICE_T_FINAL, SLICE_TOL, str(OUT_DIR), dev),
        SLICE_TOL, lambda k: 1.0e-8)
    check(isinstance(s._ode_solver, pt.KrylovSolver)
          and s._backend_used == "box",
          "the repressilator did not run Krylov on the box")
    tables(4, "repressilator final operator", s._operator)
    final_operator(4, "repressilator", s, SLICE_T_FINAL)
    keep = {}
    k12["repressilator"] = layout_kernel_times(
        dev, smi, "repressilator", s, rep, SLICE_T_FINAL, True, max_err,
        keep)
    #: phase 14's boxes: the final operators' (model, capacity,
    #: constraints, mask) and p, without the operators, held on the host
    #: so that the later phases' peaks of device memory do not hold them
    ablate14 = [ka.operator_case(
        f"repressilator t={SLICE_T_FINAL:g}, {key}", op, p,
        SLICE_T_FINAL).to("cpu") for key, (op, p) in keep.items()]
    del keep
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

    # through bench_configs' hog1p config (the example's configuration)
    s, d5, launch5, wall5 = run_entry(
        5, f"hog1p_5d t={HOG_T_FINAL:g} tol={HOG_TOL:g}",
        lambda: bench_configs.run_hog1p(box_opts, dev), HOG_TOL,
        bdf_mass_tol)
    check(isinstance(s._ode_solver, pt.BdfSolver),
          "hog1p_5d did not run the BDF integrator")
    check(launch5["synth"] > 0, "hog1p_5d launched no K3 kernel")
    ev = s.get_event_log().events
    attempts = ev["HostSync.BDFErrorNorm"].count
    print(f"[5] GMRES matvecs {ev['RHSEvaluation'].count - attempts} "
          f"(RHS evaluations less one per step attempt)", flush=True)
    tables(5, "hog1p_5d final operator", s._operator)
    final_operator(5, "hog1p_5d", s, HOG_T_FINAL)
    keep = {}
    k12["hog1p_5d"] = layout_kernel_times(
        dev, smi, "hog1p_5d", s, hog, HOG_T_FINAL, True, max_err, keep)
    ablate14.append(ka.operator_case(
        f"hog1p_5d t={HOG_T_FINAL:g}, box order", *keep["box order"],
        HOG_T_FINAL).to("cpu"))
    del keep
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
    keep = {}
    k12["transcr_reg_6d"] = layout_kernel_times(
        dev, smi, "transcr_reg_6d", s, tr6, TR6_T_FINAL, False, max_err,
        keep)
    ablate14.append(ka.operator_case(
        f"transcr_reg_6d t={TR6_T_FINAL:g}, box order", *keep["box order"],
        TR6_T_FINAL).to("cpu"))
    del keep
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
    clock(7)
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
        """Per slab the generator's CSR rows of that slab (the function of
        one K4 launch) in both readings of :func:`library_readings`, each
        checked against the slab's K4 (dp, sinks) in ``k4``; ms per sweep,
        the lesser reading's."""
        plane = geom.plane
        per = {}
        for w, (kp, ks) in zip(windows, k4):
            g = w[0]
            lo = (g.origin0 + g.out_lo) * plane
            A = generator_csr(c, mask, a.dense(), viol, geom.shape,
                              geom.stoich, geom.nc, (lo, lo + g.n_out))
            r = library_readings(f"{label}: a slab", A, geom.nc, p,
                                 (kp, ks), reps)
            for k, v in r.items():
                per.setdefault(k, []).append(v)
            del A
        print(f"[7a] {label} library, each slab's CSR rows (us): " + "; ".join(
            f"{k} " + " / ".join(f"{t * 1e3:.1f}" for t in v)
            + f", a sweep {sum(v) * 1e3:.1f}" for k, v in per.items()),
            flush=True)
        return min(sum(v) for v in per.values())

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
    hmask, hviol = k1_data(host_op)
    hp = hmask.to(torch.float64)
    hc, hb = host_op.model.coefficients(60.0), host_op.data().bounds
    hw = slab_windows(host_op.geom, hp, hmask, host_op.props, hviol)
    host["K4"] = base_probe.host_us(lambda: k4_launch("synth", hc, hb,
                                                      hw[1]))
    host["K4 mask"] = base_probe.host_us(lambda: k4_launch("mask", hc, hb,
                                                           hw[1]))
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
            op4.geom.nc, k1_4, reps=10, stoich=op4.stoichiometry)
    del win4, k1_4, mask4, viol4
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
        run_ranks(world, "nccl", SLICE_T_FINAL, SLICE_TOL), SLICE_TOL, 1)
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
        SLICE_TOL, 1)
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
    clock(8)
    probe_entries = probe_phase(dev, smi, {
        "K1": (ms["K1"], roof_bytes["K1"]), "K3": (ms["K3"], roof_bytes["K3"]),
        "K4": (ms4["K4_synth"], roof_bytes["K4"])})

    # ---------------------------------------------------------- phase 9
    clock(9)
    launch9, k9 = sens_phase(dev, smi, d5, bdf_mass_tol, run_entry,
                                     tables,
                             same_twice, max_err)

    # --------------------------------------------------------- phase 10
    clock(10)
    launch10c, launch10e, d10 = ell_phase(dev, smi, run_solve,
                                          final_operator, rep, d4, op4, p4,
                                          d1)
    del op4, p4
    torch.cuda.empty_cache()

    # --------------------------------------------------------- phase 11
    clock(11)
    launch11a, launch11b, k9w_launches, k9w, halo12 = petsc_phase(
        dev, smi, run_solve, rep, d4, d1, d10, max_err)

    # --------------------------------------------------------- phase 12
    clock(12)
    launch12 = layout_phase(dev, smi, run_solve, layouts, k12, halo12,
                            wall5, d5, bdf_mass_tol)

    # --------------------------------------------------------- phase 13
    clock(13)
    launch13a, launch13b, launch13c, launch13d = entry_phase(
        dev, smi, run_entry, final_operator, rep, d4, d6, bdf_mass_tol)

    # --------------------------------------------------------- phase 14
    clock(14)
    t14 = time.perf_counter()
    uncounted(lambda: ablation_phase(smi, ablate14))
    del ablate14
    print(f"[clock] phase 14 took {time.perf_counter() - t14:.1f} s",
          flush=True)

    # --------------------------------------------------------- phase 15
    clock(15)
    bdf15 = bdf_step_phase(dev, smi)
    bdf15["launches"] = sum(bdf_launches.values())
    print(f"[15] fused step launches in the solves above {bdf_launches}",
          flush=True)
    check(all(bdf_launches.values()), "no solve took the fused BDF step")

    paths = (launch4, launch5, launch6, launch9, launch10c, launch10e,
             launch11a, launch11b, launch12, launch13a, launch13b,
             launch13c, launch13d)
    clock("end")
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
         "launches": launch7b + launch7c + sum(
             lc["sharded_mask"] + lc["sharded_synth"]
             for lc in (launch13c, launch13d)),
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
         "library_ms": k9["library_ms"]},
        {"name": "box_action_batched_sharded", "route": "cuda",
         "source": "pacmensl_tpu_torch/csrc/box_action.cu",
         "replaces": "pacmensl_tpu/ops/sens_operator.py:151",
         "launches": k9w_launches,
         "max_abs_err": max_err["batched_sharded"],
         "ms": k9w["ms"], "plain_ms": k9w["plain_ms"],
         "bound_ms": k9w["bound"][0], "bound_by": k9w["bound"][1],
         "library_ms": k9w["library_ms"]}, bdf15] + probe_entries}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
