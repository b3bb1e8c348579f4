"""Integrator (``solvers/krylov.py``, ``solvers/bdf.py``,
``ops/gmres.py``): seconds in the ``EventLog`` phase ``ODESolve``, per
solve."""


def read(ctx):
    return ctx.per_solve(lambda s: s.event_s("ODESolve"))
