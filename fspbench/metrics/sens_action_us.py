"""Sensitivity operator (``ops/sens_operator.py``): microseconds per
stacked action, the program's ``SensAction`` span (c(t), the batched
action over p and every s_j, the derivative operators and the adds),
over the window's solves, in the traced run (so with the profiler on).
None where the program records no such span."""


def read(ctx):
    n = sum(s.event_count("SensAction") for s in ctx.solves)
    if not n:
        return None
    return 1e6 * sum(s.event_s("SensAction") for s in ctx.solves) / n
