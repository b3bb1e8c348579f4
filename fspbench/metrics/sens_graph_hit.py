"""Sensitivity operator: the share of the stacked solve's GMRES Arnoldi
iterations replayed from a CUDA graph captured before, 100 x (1 -
captures / replays) per solve, from the program's ``GMRESCapture`` and
``GMRESReplay`` spans (one per capture and per replay of an iteration's
graph, the K9 launch, the derivative launches and their adds included),
over the window's solves that replay: ``arnoldi_graph_hit``'s reader in
the sensitivity cell.  None where the program records no replay (a
program whose stacked action GMRES runs eagerly)."""
from fspbench.lib import runner


def read(ctx):
    return runner.metric_reader("arnoldi_graph_hit")(ctx)
