"""The frozen count of an operator action's work.  It depends on the
states and the network only, not on the backend, the kernel or its
layout, so a later change to any of them leaves the yardstick as it is:

* bytes: 8 B read and 8 B written per state (p in, dp out, float64) and
  8 B per sink;
* flops: 4 per reaction and state (the propensity times p, the inflow
  and the outflow terms).

At 3.35 TB/s these flops take 0.5 R flop per byte, under the H100's
FP64 peak over its bandwidth (67 TFLOP/s over 3.35 TB/s = 20), so the
bytes bound the action."""
from __future__ import annotations


def action_work(n_states: int, n_sinks: int, n_reactions: int):
    """``(bytes, flops)`` of one action on ``n_states`` states."""
    return (16.0 * n_states + 8.0 * n_sinks,
            4.0 * n_reactions * n_states)
