"""Integrator: seconds per solve the host sat blocked in the program's
``HostSync.<site>`` reads (the work queued before each read, plus the
copy).  None where the program records no such span."""


def read(ctx):
    if not any(k.startswith("HostSync.") for s in ctx.solves
               for k in s.events):
        return None
    return ctx.per_solve(lambda s: sum(
        v for k, (_, v) in s.events.items() if k.startswith("HostSync.")))
