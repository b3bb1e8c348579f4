"""Operator, host side: microseconds of host time per operator action
(the enqueue, no synchronisation), from the benchmark's wrap, in the
traced run (so with the profiler's per-operation cost on the host)."""


def read(ctx):
    log = ctx.actions
    if log is None or not log.host_s:
        return None
    return 1e6 * sum(log.host_s) / len(log.host_s)
