"""Sensitivity operator and kernel (``ops/sens_operator.py``, K9 and the
derivative launches of ``csrc/box_action.cu``): the stacked actions'
frozen bytes over 3.35 TB/s, divided by the device time of the box
kernel's launches in the window, in percent.

The bytes are :mod:`fspbench.lib.counts`'s 16 B per state and 8 B per
sink over the vector-states and vector-sinks the actions covered, the
program's counters ``SensActionStates`` and ``SensActionSinks`` ((1 + Np)
x the states, and x the constraints, per action): (1 + Np) x (16 B per
state + 8 B per sink) an action, whatever implements it.  The device
time is that of the device operations whose name holds ``box_action``
(K9 over p and every s_j, and one launch per derivative operator), from
the reduced trace's operations by name; in a sensitivity solve every box
kernel launch is one of a stacked action's.  None where the program
records no such counter or the trace no such operation."""

from fspbench.lib.counts import action_work
from fspbench.lib.trace import HBM_BYTES_PER_S

KERNEL = "box_action"


def read(ctx):
    states = sum(s.event_count("SensActionStates") for s in ctx.solves)
    sinks = sum(s.event_count("SensActionSinks") for s in ctx.solves)
    tr = ctx.trace
    if not states or tr is None:
        return None
    device_s = sum(v for name, v in tr.device_ops if KERNEL in name)
    if device_s <= 0:
        return None
    return 100.0 * action_work(states, sinks, 0)[0] / HBM_BYTES_PER_S \
        / device_s
