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
Needs a CUDA card.
"""
import os
import subprocess
import sys
import time

T_FINAL, FSP_TOL, REPS, ROUNDS = 30.0, 1.0e-4, 200, 3


def _time_ms(torch, fn) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(REPS):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / REPS


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
            times[k].append(_time_ms(torch, fn))
    print(f"{label}: repressilator t=10 final operator {op.shape} "
          f"({d.num_states} states, solve {wall:.2f} s); us per launch "
          + ", ".join(f"{k} " + " / ".join(f"{v * 1e3:.1f}" for v in vs)
                      for k, vs in times.items()) + f"; {smi}", flush=True)


def main(label: str = "") -> None:
    import torch
    import pacmensl_tpu_torch as pt
    from pacmensl_tpu_torch.ops import box_kernel as bk
    from pacmensl_tpu_torch.ops import box_operator as bo
    from pacmensl_tpu_torch.sys.errors import SetupError
    if not torch.cuda.is_available():
        raise SetupError("time_k1 needs a CUDA card")
    dev = torch.device("cuda", 0)
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
            times[k].append(_time_ms(torch, k1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
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
    main(sys.argv[1] if len(sys.argv) > 1 else "")
