"""The program under test, driven through its public API as a parameter
fit drives it: the network as the program's ``Model`` and constraint
functions, a new solver per request (options, model, constraint
functions, initial bounds, expansion factors, initial distribution), and
what the benchmark reads back (the ``EventLog``, the backend, the box's
capacity, the kernel's launch counters).  The request kinds
(``requests/<kind>.py``) build the program's objects through it."""
from __future__ import annotations

import torch

import pacmensl_tpu_torch as pt
from pacmensl_tpu_torch.statespace import constraints as ptc

from .config import Config, constraint_values


def model(cfg: Config, factors) -> "pt.Model":
    """The network with every propensity times its rate factor."""
    f = [float(v) for v in factors]

    def prop(x, r):
        xf = x if x.is_floating_point() else x.to(torch.float64)
        return cfg.propensity(xf, r, f)

    tv = cfg.tv_reactions
    return pt.Model(cfg.stoich, prop,
                    cfg.t_coeff if tv else None,
                    tv_reactions=tv)


def constraint_fn(cfg: Config):
    """The configuration's constraints as the program takes them: a
    function of the states with ``components`` and the closed ``form``
    the box kernel evaluates, built by the program's form helpers."""
    forms = cfg.forms

    def fn(x):
        return constraint_values(forms, x)

    def form(weights, products):
        if products:
            (u, i, j), = products
            return ptc.product(i, j, u)
        return ptc.linear(dict(weights))

    fn.components = tuple((lambda x, _k=k: constraint_values([forms[_k]],
                                                             x)[:, 0])
                          for k in range(len(forms)))
    fn.form = tuple(form(w, p) for w, p in forms)
    return fn


def new_solver(cfg: Config, factors, device="cuda", backend=None):
    """A solver set up for one request, as a fit sets one up."""
    kw = {} if backend is None else {"backend": backend}
    s = pt.FspSolverMultiSinks(device=device, **kw)
    s.set_from_options(pt.Options.from_argv(list(cfg.data["solver_options"])))
    s.set_model(model(cfg, factors))
    s.set_constraint_functions(constraint_fn(cfg))
    s.set_initial_bounds(cfg.bounds)
    s.set_expansion_factors(cfg.expansion_factors)
    s.set_initial_distribution(cfg.x0, cfg.p0)
    return s


def record(s) -> dict:
    """What a solve's metrics read of its solver: the ``EventLog``'s
    phases and counts, the backend the solve ended on (``"box"`` or
    ``"ell"``) and the box's capacity (``()`` on ELL)."""
    ev = s.get_event_log().events
    space = s._space
    return {"events": {k: (v.count, v.total_s) for k, v in ev.items()},
            "backend": s._backend_used,
            "capacity": tuple(int(c) for c in getattr(space, "shape", ()))}


def build_seconds() -> float:
    """Seconds this process spent building the box kernel's library (0
    where a build in the checkout was loaded, or none was needed)."""
    from pacmensl_tpu_torch.ops import box_kernel
    return float(box_kernel.KERNEL.build_seconds or 0.0)


def operator_classes():
    """The operator classes whose ``action`` the benchmark wraps."""
    from pacmensl_tpu_torch.ops.box_operator import BoxOperator
    from pacmensl_tpu_torch.ops.ell_operator import EllOperator
    return (BoxOperator, EllOperator)


def event_log_class():
    return pt.EventLog


def action_work(op):
    """The frozen work count (:mod:`.counts`) of one action of ``op``, a
    box or ELL operator, on its current state set."""
    from .counts import action_work as work
    n = (op.space.num_states if hasattr(op, "space")
         else op.state_set.num_states)
    return work(n, op.num_constraints, len(op.enable_reactions))


def kernel_launches() -> dict:
    """The box kernel's launches by mode since the process started."""
    from pacmensl_tpu_torch.ops import box_kernel
    return dict(box_kernel.KERNEL.launches)


def reset_kernel_counts() -> None:
    from pacmensl_tpu_torch.ops import box_kernel
    box_kernel.KERNEL.reset_counts()
