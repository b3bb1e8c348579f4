"""Timing helpers shared by the port's measurement tools and
``chip_smoke.py``: the card's name and power limit, CUDA events around
back-to-back calls, the same calls replayed from a CUDA graph, and the
slab windows the batched launch on a window (K9w) is timed on.

Every function imports what it needs when it is called, so that
``tools/time_k1.py`` can load this file by its path and time the package
of an older checkout with it.
"""
from __future__ import annotations


def card(dev=None) -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, to
    stand beside every number timed on it; for a CPU ``dev``, a line that
    says the numbers are the host's."""
    import subprocess
    if dev is not None and dev.type != "cuda":
        return "host CPU (the plain versions; no device number)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 100, warm: int = 5) -> float:
    """ms per call of ``fn``: CUDA events around ``reps`` back-to-back
    calls after ``warm`` warm-up calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps: int = 100) -> float:
    """ms per call of ``fn`` replayed from a CUDA graph of ``reps`` calls:
    the device's time without the host's cost per call."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def k9w_windows(geom, P, slabs: int):
    """``geom``'s box cut into ``slabs`` axis-0 slabs, each a window with
    every vector's halo planes as ShardedBoxAction.batched's exchange
    delivers them.  Per slab: (the window's geometry, the slab of
    ``P [nb, n]``, the halos ``(up, dn)``, each ``[nb, w0 P]``, the
    window's origin and rows)."""
    import numpy as np
    import torch
    from pacmensl_tpu_torch.ops import box_kernel as bk
    from pacmensl_tpu_torch.parallel.halo_box import halo_width, window_rows
    nb, shape, g0, plane = P.shape[0], geom.shape, geom.shape[0], geom.plane
    w0 = halo_width(geom.stoich)

    def rows_of(lo, rows):
        return torch.stack([window_rows(P[i].reshape(shape), lo, rows)
                            .reshape(-1) for i in range(nb)])

    out = []
    cuts = np.linspace(0, g0, slabs + 1).astype(int)
    for lo, hi in zip(cuts[:-1].tolist(), cuts[1:].tolist()):
        o, rows, L0 = lo - w0, hi - lo + 2 * w0, hi - lo
        g = bk.BoxGeometry((rows,) + shape[1:], geom.stoich, geom.nc,
                           geom.form, origin0=o, g0=g0,
                           out_rows=(w0, w0 + L0), halo_rows=(w0, L0))
        out.append((g, P[:, lo * plane:hi * plane].contiguous(),
                    (rows_of(o, w0), rows_of(hi, w0)), o, rows))
    return out
