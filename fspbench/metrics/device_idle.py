"""Device (H100): 1 - (union of the device operations' intervals) /
(the traced window), from ``torch.profiler``'s device trace, in
percent."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
