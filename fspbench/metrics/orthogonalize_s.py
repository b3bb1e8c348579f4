"""Integrator: seconds per solve in GMRES's modified Gram-Schmidt, the
program's ``GMRESOrthogonalize`` span (one per Arnoldi iteration, its
host sync excluded).  None where the program records no such span."""


def read(ctx):
    if not any("GMRESOrthogonalize" in s.events for s in ctx.solves):
        return None
    return ctx.per_solve(lambda s: s.event_s("GMRESOrthogonalize"))
