"""Driver (``fsp/solver.py``): seconds a solve spends growing the state
space and rebuilding the operator, the ``EventLog`` phases
``StatePartitioning`` (which holds ``BoxReorder``), ``MatrixGeneration``
and ``SolutionScatter``, per solve."""

PHASES = ("StatePartitioning", "MatrixGeneration", "SolutionScatter")


def read(ctx):
    return ctx.per_solve(lambda s: sum(s.event_s(p) for p in PHASES))
