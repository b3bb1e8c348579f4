"""Device: the largest ``torch.cuda.max_memory_allocated()`` over the
window's solves (reset before each), in GiB; nothing off a card."""


def read(ctx):
    peak = max((s.peak_bytes for s in ctx.solves), default=0)
    return peak / 2.0**30 if peak > 0 else None
