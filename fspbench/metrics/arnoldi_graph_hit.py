"""Integrator: the share of GMRES's Arnoldi iterations replayed from a
CUDA graph captured before, 100 x (1 - captures / replays) per solve,
from the program's ``GMRESCapture`` and ``GMRESReplay`` spans (one per
capture and per replay of an iteration's graph), over the window's
solves that replay.  None where the program records no replay."""


def read(ctx):
    hits = [100.0 * (1.0 - s.event_count("GMRESCapture")
                     / s.event_count("GMRESReplay"))
            for s in ctx.solves if s.event_count("GMRESReplay")]
    if not hits:
        return None
    return sum(hits) / len(hits)
