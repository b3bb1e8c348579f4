"""Operator, host side: microseconds per operator action, the program's
``OperatorAction`` span, over the window's solves (the program's twin of
``action_host_us``, read inside the benchmark's wrap).  None where the
program records no such span."""


def read(ctx):
    n = sum(s.event_count("OperatorAction") for s in ctx.solves)
    if not n:
        return None
    return 1e6 * sum(s.event_s("OperatorAction") for s in ctx.solves) / n
