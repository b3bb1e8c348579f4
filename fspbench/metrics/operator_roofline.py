"""Operator and kernel (``ops/box_operator.py``, ``ops/box_kernel.py``,
``csrc/box_action.cu``, ``ops/ell_operator.py``): the frozen count of the
actions' bytes (``lib/counts.py``) over 3.35 TB/s, divided by the device
time of the operations launched inside the actions, in percent."""

from fspbench.lib.trace import HBM_BYTES_PER_S


def read(ctx):
    tr, log = ctx.trace, ctx.actions
    if tr is None or log is None or tr.action_device_s <= 0:
        return None
    return 100.0 * sum(log.bytes) / HBM_BYTES_PER_S / tr.action_device_s
