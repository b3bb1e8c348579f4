"""Operator, host side: microseconds per evaluation of the model's time
coefficients c(t) inside an action, the program's ``ModelCoefficients``
span, over the window's solves.  None where the program records no such
span."""


def read(ctx):
    n = sum(s.event_count("ModelCoefficients") for s in ctx.solves)
    if not n:
        return None
    return 1e6 * sum(s.event_s("ModelCoefficients") for s in ctx.solves) / n
