"""Sensitivity operator: the derivative part's share of the stacked
action, 100 x ``SensDerivative`` seconds / ``SensAction`` seconds per
solve (the program's spans: the derivative operators' actions and their
adds, inside the whole action), over the window's solves.  None where
the program records no such span."""


def read(ctx):
    shares = [100.0 * s.event_s("SensDerivative") / s.event_s("SensAction")
              for s in ctx.solves if s.event_s("SensAction") > 0]
    if not shares:
        return None
    return sum(shares) / len(shares)
