"""Integrator: the share of BDF's step attempts whose vector arithmetic
outside GMRES took the fused CUDA passes (``ops/bdf_step.py``), 100 x
``BDFFusedStep`` / ``HostSync.BDFErrorNorm`` per solve (the program reads
the error norm once per attempt, fused or not), over the window's solves.
None where the program records no fused step."""


def read(ctx):
    shares = []
    for s in ctx.solves:
        fused = s.event_count("BDFFusedStep")
        if not fused:
            continue
        shares.append(100.0 * fused / s.event_count("HostSync.BDFErrorNorm"))
    if not shares:
        return None
    return sum(shares) / len(shares)
