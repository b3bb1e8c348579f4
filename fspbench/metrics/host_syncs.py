"""Integrator: blocking device-to-host reads per solve, the count of the
program's ``HostSync.<site>`` spans (``ops/vecops.to_host``: GMRES's
norms and Hessenberg columns, BDF's error norms, the stop-check's and
each epoch's sinks).  None where the program records no such span."""


def read(ctx):
    counts = [sum(c for k, (c, _) in s.events.items()
                  if k.startswith("HostSync.")) for s in ctx.solves]
    if not any(counts):
        return None
    return sum(counts) / len(counts)
