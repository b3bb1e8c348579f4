"""Time the box kernel's mask-reading mode (K1) where the rows are short,
and both modes at the repressilator's final capacity.

    cd <checkout> && python <path to this file> [label]

Solves transcr_reg_6d to t = 30 (fsp_tol 1e-4) on the card with the
``pacmensl_tpu_torch`` of the checkout in the current directory, so that
the same file times an older checkout too, then times K1 on the final
operator (rows of the last axis of 13 elements, two reactions on field
rows): CUDA events over 200 back-to-back launches after 10 warm-up
launches, three rounds, each launch first checked bitwise against the
plain version.  Where the checkout keeps propensity tables it times K1 on
them and on the ``[R, n]`` fields; an older one only on the fields.  Then
solves the repressilator to t = 10 (fsp_tol 1e-4, Krylov) and times K3
and K1 on its final operator (211 x 316 x 211) and solution the same way,
on the tables.  Prints two lines, with the card's name and power limit.

    python <path to this file> [label] --k9

times the batched launch K9 (synthesized-mask mode) instead: at the
128^3 repressilator box with nb = 2, 3 and 4 and at hog1p_5d's final
capacity after a solve to t = 180 (4 x 42 x 94 x 42 x 63, the capacity
hog1p_5d_sens ends at) with nb = 3, each beside nb single K3 launches on
the same vectors, three rounds, each launch first checked bitwise against
the single launches.  Prints one line per case.  Needs a CUDA card.

    python <path to this file> [label] --k9w

times the batched launch on a window (K9w, synthesized-mask mode, nb = 3)
in one launch a slab, as a sweep over the slabs: the 128^3 repressilator
box in 4 slabs, hog1p_5d's final capacity after a solve to t = 180 in 2
slabs, and the final box of hog1p_5d_sens to t = 3 (fsp_tol 1e-6,
Krylov) in 2 slabs, where the fixed cost of a launch dominates; beside
each, the sweep of single-vector launches on the first vector (K4, one a
slab), K9 on the whole box, and on the last box one K3 launch.  Three
rounds, each sweep first checked bitwise against nb single K4 launches
a slab; each also replayed from a CUDA graph (the device's time without
the host's cost per launch).  The slab windows and the graph's timing
are ``tools/timing.py``'s (``chip_smoke.py`` phase 11d takes them from
there too), loaded by its path from the directory this file lies in, so
that an older checkout's package is timed with them.  Prints one line per
case.  Needs a CUDA card.
"""
import argparse
import functools
import os
import sys
import time

T_FINAL, FSP_TOL, REPS, ROUNDS = 30.0, 1.0e-4, 200, 3


@functools.cache
def _timing():
    """``tools/timing.py`` beside this file, loaded by its path: the
    package in the current directory may be an older checkout's."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().with_name("timing.py")
    spec = importlib.util.spec_from_file_location("_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _time_ms(fn) -> float:
    return _timing().time_ms(fn, REPS, 10)


def _solve(pt, bundle, odes, t_final, dev):
    s = pt.FspSolverMultiSinks(backend="box", odes_type=odes, device=dev)
    s.set_model(bundle.model)
    s.set_constraint_functions(bundle.constraint)
    s.set_initial_bounds(bundle.bounds)
    s.set_expansion_factors(bundle.expansion_factors)
    s.set_initial_distribution(bundle.x0, bundle.p0)
    return s, s.solve(t_final, FSP_TOL)


def _repressilator(torch, pt, bk, bo, dev, smi, label) -> None:
    """K3 and K1 on the repressilator's final operator and solution."""
    t0 = time.perf_counter()
    s, d = _solve(pt, pt.models.repressilator(), "krylov", 10.0, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    op = s._operator
    mask = op.space.mask.reshape(-1).to(torch.uint8)
    viol = bo.violation_bits(op.space.constraints, op.model.stoichiometry,
                             op.shape, dev)
    c, p, b = op.model.coefficients(10.0), s._y.p, op.data().bounds
    runs = {"K3": lambda: bk.box_action_synth(c, p, op.props, b, op.geom),
            "K1": lambda: bk.box_action(c, p, mask, op.props, viol,
                                        op.geom)}
    want = bk.box_action_reference(c, p, mask, op.props, viol, op.geom)[0]
    times = {k: [] for k in runs}
    for _ in range(ROUNDS):
        for k, fn in runs.items():
            got = fn()[0]
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{k} is not bitwise the plain version")
            times[k].append(_time_ms(fn))
    print(f"{label}: repressilator t=10 final operator {op.shape} "
          f"({d.num_states} states, solve {wall:.2f} s); us per launch "
          + ", ".join(f"{k} " + " / ".join(f"{v * 1e3:.1f}" for v in vs)
                      for k, vs in times.items()) + f"; {smi}", flush=True)


def _k9(torch, pt, bk, bo, dev, smi, label) -> None:
    """K9 against nb single K3 launches on the same vectors."""
    gen = torch.Generator(device=dev).manual_seed(7)
    rep = pt.models.repressilator()
    shape = (128,) * 3
    n = 128 ** 3
    cs = pt.ConstraintSet(None, [127] * 3, None, 3)
    geom = bk.BoxGeometry(shape, rep.model.stoichiometry, 3, cs.form)
    a = bo.propensity_tables(rep.model, shape, dev)
    P = torch.rand((4, n), generator=gen, device=dev, dtype=torch.float64)
    cases = [(f"128^3 nb={nb}", geom, a, [127] * 3,
              rep.model.coefficients(0.0), P[:nb].contiguous())
             for nb in (2, 3, 4)]
    s, d = _solve(pt, pt.models.hog1p_5d(), "auto", 180.0, dev)
    op = s._operator
    p = s._y.p
    noise = torch.rand((2, op.geom.n), generator=gen, device=dev,
                       dtype=torch.float64) - 0.5
    P3 = torch.cat([p[None], p[None] * noise]).contiguous()
    cases.append((f"hog1p_5d t=180 final {op.shape} nb=3", op.geom,
                  op.props, op.data().bounds,
                  op.model.coefficients(180.0), P3))
    del s, d, noise
    times = {c[0]: {"K9": [], "single": []} for c in cases}
    for rnd in range(ROUNDS):
        for name, g, pa, b, c, Q in cases:
            nb = Q.shape[0]

            def k9():
                return bk.box_action_synth_batched(c, Q, pa, b, g)

            def single():
                return [bk.box_action_synth(c, Q[i], pa, b, g)
                        for i in range(nb)]
            if rnd == 0:
                got, one = k9(), single()
                torch.cuda.synchronize()
                if not (torch.equal(got[0], torch.stack([o[0] for o in one]))
                        and torch.equal(got[1],
                                        torch.stack([o[1] for o in one]))):
                    raise AssertionError(f"{name}: K9 is not bitwise the "
                                         "single launches")
            times[name]["K9"].append(_time_ms(k9))
            times[name]["single"].append(_time_ms(single))
    for name, t in times.items():
        nb = int(name[-1])
        print(f"{label}: {name}: us per call K9 "
              + " / ".join(f"{x * 1e3:.1f}" for x in t["K9"])
              + f", {nb} single K3 launches "
              + " / ".join(f"{x * 1e3:.1f}" for x in t["single"])
              + f"; per vector K9 {min(t['K9']) / nb * 1e3:.1f}, single "
              f"{min(t['single']) / nb * 1e3:.1f}; {smi}", flush=True)


def _k9w(torch, pt, bk, bo, dev, smi, label) -> None:
    """K9w sweeps of one launch a slab, beside K9 on the whole box."""
    timing = _timing()
    gen = torch.Generator(device=dev).manual_seed(7)
    rep = pt.models.repressilator()
    shape = (128,) * 3
    cs = pt.ConstraintSet(None, [127] * 3, None, 3)
    geom = bk.BoxGeometry(shape, rep.model.stoichiometry, 3, cs.form)
    P = torch.rand((3, 128 ** 3), generator=gen, device=dev,
                   dtype=torch.float64)
    cases = [("128^3 in 4 slabs", geom,
              bo.propensity_tables(rep.model, shape, dev), [127] * 3,
              rep.model.coefficients(0.0), P, 4)]
    s, d = _solve(pt, pt.models.hog1p_5d(), "auto", 180.0, dev)
    op = s._operator
    noise = torch.rand((2, op.geom.n), generator=gen, device=dev,
                       dtype=torch.float64) - 0.5
    cases.append((f"hog1p_5d t=180 final {op.shape} in 2 slabs", op.geom,
                  op.props, op.data().bounds, op.model.coefficients(180.0),
                  torch.cat([s._y.p[None], s._y.p[None] * noise]), 2))
    del s, d, noise, op
    hs = pt.models.hog1p_5d_sens()
    s = pt.SensFspSolverMultiSinks(backend="box", odes_type="krylov",
                                   device=dev)
    s.set_model(hs.model)
    s.set_constraint_functions(hs.constraint)
    s.set_initial_bounds(hs.bounds)
    s.set_expansion_factors(hs.expansion_factors)
    s.set_initial_distribution(hs.x0, hs.p0)
    s.set_ode_tolerances(1.0e-9, 1.0e-14)
    d = s.solve(3.0, 1.0e-6)
    op = s._operator.base
    cases.append((f"hog1p_5d_sens t=3 final {op.shape} ({d.num_states} "
                  "states) in 2 slabs", op.geom, op.props, op.data().bounds,
                  op.coefficients(3.0), s._y.p.view(3, op.geom.n).clone(),
                  2))
    del s, d, op
    times = {c[0]: {k: [] for k in ("K9w", "K4", "K9", "K3", "K9w graph",
                                    "K4 graph", "K9 graph", "K3 graph")}
             for c in cases}
    for rnd in range(ROUNDS):
        for name, g, pa, b, c, Q, slabs in cases:
            wins = [((wg, ps, h), pa.window(o, rows)) for wg, ps, h, o,
                    rows in timing.k9w_windows(g, Q, slabs)]

            def k9w():
                return [bk.box_action_synth_batched(c, ps, wa, b, wg,
                                                    halos=h)
                        for (wg, ps, h), wa in wins]
            def k4():
                return [bk.box_action_synth(c, ps[0], wa, b, wg,
                                            halos=(up[0], dn[0]))
                        for (wg, ps, (up, dn)), wa in wins]
            runs = {"K9w": k9w, "K4": k4,
                    "K9": lambda: bk.box_action_synth_batched(c, Q, pa, b,
                                                              g)}
            if name.startswith("hog1p_5d_sens"):
                runs["K3"] = lambda: bk.box_action_synth(c, Q[0], pa, b, g)
            if rnd == 0:
                for ((wg, ps, (up, dn)), wa), (kp, ks) in zip(wins, k9w()):
                    one = [bk.box_action_synth(c, ps[i], wa, b, wg,
                                               halos=(up[i], dn[i]))
                           for i in range(Q.shape[0])]
                    torch.cuda.synchronize()
                    if not (torch.equal(kp, torch.stack([o[0] for o in one]))
                            and torch.equal(ks, torch.stack(
                                [o[1] for o in one]))):
                        raise AssertionError(f"{name}: K9w is not bitwise "
                                             "the K4 launches")
            for k, fn in runs.items():
                times[name][k].append(_time_ms(fn))
                times[name][k + " graph"].append(timing.graph_ms(fn, REPS))
    for name, t in times.items():
        print(f"{label}: {name}, nb=3: us per call "
              + ", ".join(f"{k} " + " / ".join(f"{x * 1e3:.1f}" for x in v)
                          for k, v in t.items() if v)
              + f"; {smi}", flush=True)


def main(label: str = "", k9: bool = False, k9w: bool = False) -> None:
    import torch
    import pacmensl_tpu_torch as pt
    from pacmensl_tpu_torch.ops import box_kernel as bk
    from pacmensl_tpu_torch.ops import box_operator as bo
    from pacmensl_tpu_torch.sys.errors import SetupError
    if not torch.cuda.is_available():
        raise SetupError("time_k1 needs a CUDA card")
    dev = torch.device("cuda", 0)
    if k9 or k9w:
        smi = _timing().card()
        (_k9w if k9w else _k9)(torch, pt, bk, bo, dev, smi, label)
        return
    t0 = time.perf_counter()
    s, d = _solve(pt, pt.models.transcription_regulation_6d(), "auto",
                  T_FINAL, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    op = s._operator
    mask = op.space.mask.reshape(-1).to(torch.uint8)
    viol = bo.violation_bits(op.space.constraints, op.model.stoichiometry,
                             op.shape, dev)
    c, p = op.model.coefficients(T_FINAL), s._y.p
    props = {"tables": op.props} if hasattr(op, "props") else {}
    props["fields"] = op.prop_fields
    want = bk.box_action_reference(c, p, mask, props["fields"], viol,
                                   op.geom)[0]
    times = {k: [] for k in props}
    for _ in range(ROUNDS):
        for k, a in props.items():
            def k1(a=a):
                return bk.box_action(c, p, mask, a, viol, op.geom)
            got = k1()[0]
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K1 on {k} is not bitwise its plain "
                                     "version")
            times[k].append(_time_ms(k1))
    smi = _timing().card()
    print(f"{label}: transcr_reg_6d t={T_FINAL:g} final operator "
          f"{op.shape} ({op.geom.n} elements, {d.num_states} states, solve "
          f"{wall:.2f} s); K1 us per launch "
          + ", ".join(f"{k} " + " / ".join(f"{v * 1e3:.1f}" for v in vs)
                      for k, vs in times.items()) + f"; {smi}", flush=True)
    del s, op, mask, viol, p, props, want
    torch.cuda.empty_cache()
    _repressilator(torch, pt, bk, bo, dev, smi, label)


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label", nargs="?", default="")
    ap.add_argument("--k9", action="store_true",
                    help="time the batched launch K9 instead")
    ap.add_argument("--k9w", action="store_true",
                    help="time the batched launch on a window K9w instead")
    args = ap.parse_args()
    main(args.label, args.k9, args.k9w)
