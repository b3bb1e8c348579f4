"""The port's entry points for a one-card check and a multi-rank dry run.

Counterpart of the JAX package's ``__graft_entry__.py``:

* :func:`entry` returns ``(fn, args)``: one action of the CME operator of
  the 5-species hog1p MAPK model on its box at the initial bounds (the
  hot kernel of every FSP solve, the reference's
  ``FspMatrixConstrained::Action``), so ``fn(*args)`` is one K3 launch on
  a card;
* :func:`dryrun_multichip` runs :func:`dryrun_rank` on a new group of
  ``n`` ranks, one process a rank (NCCL, one rank a card; gloo on the
  CPU): one epoch of the toggle's box solve over the ranks (K4 behind the
  halo exchange), with the mass conserved within 1e-4 and no expansion,
  then the Poisson solve on ELL under GRAPH over the ranks to t = 2
  through at least two expansion epochs, within 1e-3 in L1 of
  Poisson(4).  A failed check raises.

    python -m pacmensl_tpu_torch.tools.dryrun [-n RANKS] [-device cuda|cpu]

``-n`` defaults to the visible cards on ``cuda`` and to 2 on ``cpu``.
"""
import math

import numpy as np
import torch

import pacmensl_tpu_torch as pt
from pacmensl_tpu_torch.examples import common
from pacmensl_tpu_torch.parallel.spawn import run_on_mesh


def entry(device="cuda"):
    """``(fn, example_args)``: ``fn(t, y)`` is the operator action of
    hog1p_5d on its box at the bundle's bounds, ``y`` the point mass at
    its initial state."""
    dev = pt.resolve_device(device)
    b = pt.models.hog1p_5d()
    cs = pt.ConstraintSet(b.constraint, b.bounds, b.expansion_factors)
    space = pt.BoxStateSpace(b.model.stoichiometry, cs, b.x0, device=dev)
    op = pt.BoxOperator(b.model, space)
    p0 = torch.zeros(space.shape, dtype=op.dtype, device=dev)
    p0[tuple(int(v) for v in b.x0[0])] = 1.0
    y0 = pt.FspVector(p=p0.reshape(-1), sinks=torch.zeros(
        space.num_constraints, dtype=op.dtype, device=dev))

    def fn(t, y):
        return op.action(t, y)

    return fn, (0.5, y0)


def dryrun_rank(mesh):
    """One rank's dry run over ``mesh``; returns its summary, with its box
    kernel launches by mode (raises on a failed check)."""
    from pacmensl_tpu_torch.ops import box_kernel as bk
    bk.KERNEL.reset_counts()
    n = mesh.size
    # one epoch of the solve/expand loop on the box: the Krylov
    # integrator (matvecs behind the halo exchange, dots all-reduced,
    # the FSP stop-check) over the ranks; the bounds are ample so the
    # epoch needs no expansion
    b = pt.models.toggle()
    s = pt.FspSolverMultiSinks(backend="box", odes_type="krylov", mesh=mesh)
    s.set_model(b.model)
    s.set_initial_bounds([max(3 * n, 31), 15])
    s.set_expansion_factors([0.5, 0.5])
    s.set_initial_distribution(b.x0, b.p0)
    s.set_up()
    s._y = s._initial_vector()
    s._t_now = 0.0
    s._advance(t_final=0.05, fsp_tol=1e-4)
    y = s._y
    total = float(mesh.all_reduce(y.p.sum().reshape(1))[0]) \
        + float(y.sinks.sum())
    if s._t_now < 0.05 - 1e-9:
        raise AssertionError(f"the epoch stopped early at t = {s._t_now} "
                             "(an expansion on ample bounds)")
    if abs(total - 1.0) >= 1e-4:
        raise AssertionError(f"mass {total} after one epoch")

    # expansion under the mesh: a tight-bounds solve through several
    # epochs (re-layouts and GRAPH re-orderings) against the Poisson law
    bp = pt.models.poisson(2.0)
    s2 = pt.FspSolverMultiSinks(backend="ell", odes_type="krylov",
                                mesh=mesh)
    s2.set_load_balancing_method("graph")
    s2.set_model(bp.model)
    s2.set_krylov_dim_range(10, 20)      # tiny problem: small basis
    s2.set_initial_bounds([8])
    s2.set_expansion_factors([1.0])      # few, large expansion epochs
    s2.set_initial_distribution(bp.x0, bp.p0)
    d = s2.solve(2.0, 1e-4)
    epochs = s2.events.events["ODESolve"].count
    if epochs < 2:
        raise AssertionError("tight bounds must force expansion epochs")
    lam = 4.0
    err = sum(abs(float(pi) - math.exp(-lam) * lam ** int(x[0])
                  / math.factorial(int(x[0])))
              for x, pi in zip(d.states, d.p))
    if err > 1e-3:
        raise AssertionError(f"L1 to Poisson(4) {err}")
    return {"rank": mesh.rank, "device": str(mesh.device), "mass": total,
            "t": s._t_now, "box_capacity": tuple(s._space.shape),
            "poisson_epochs": epochs, "poisson_states": d.num_states,
            "poisson_l1": err, "poisson_p": np.asarray(d.p),
            "launches": dict(bk.KERNEL.launches)}


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """:func:`dryrun_rank` on ``n_devices`` spawned ranks; their
    summaries by rank."""
    return run_on_mesh(dryrun_rank, int(n_devices), device)


def main(argv=None):
    opts = common.options(argv)
    device = common.device_of(opts)
    fn, args = entry(device)
    out = fn(*args)
    print(f"entry: one action on {tuple(out.p.shape)}, sum(dp) + "
          f"sum(sinks) = {float(out.p.sum() + out.sinks.sum()):.3e}",
          flush=True)
    cards = torch.cuda.device_count() if device.type == "cuda" else 2
    res = dryrun_multichip(opts.get_int("n", cards), device.type)
    for r in res:
        print(f"rank {r['rank']} ({r['device']}): mass {r['mass']:.12f} at "
              f"t = {r['t']:g}, box {r['box_capacity']}; Poisson "
              f"{r['poisson_epochs']} epochs, {r['poisson_states']} states, "
              f"L1 {r['poisson_l1']:.3e}", flush=True)
    return res


if __name__ == "__main__":
    main()
