"""Bandwidth probes of the box kernel's memory path (the port's counterpart
of ``tools/bw_probe.py``).

    python -m pacmensl_tpu_torch.tools.bw_probe [--device cuda|cpu]
        [--tiles G] [--dtype f32|f64]

Five measurements, one line each on stderr, of buffers of G blocks of
T = 4096 rows of L = 128 elements with halo blocks of H = 160 rows:

1. a torch elementwise stream ``a * 1.0000001`` (the reference's XLA
   stream, and K6's library yardstick);
2. K6, :func:`~..ops.probes.scaled_copy`;
3. K7, :func:`~..ops.probes.window_copy` (zero halos, ``c = 1``);
4. K8, :func:`~..ops.probes.roll_window` with the flat strides of a 141^3
   box (+-19881, +-141, +-1);
5. the plain torch pad and halo assembly of the 141^3 box into the G = 6
   buffer (the reference's XLA wrapper cost).

1-4 run at the reference's shape (G = 6: 12.6 MB per float32 buffer) and
at G = ``--tiles`` (default 96: 201 MB); 5 at the reference's shape.  On a
card each time is CUDA events around 100 back-to-back calls after a
warm-up, and a line says where both buffers fit the card's L2 cache.
``--device cpu`` runs the plain versions under the host clock (3 calls),
a host number and no device one.  Without ``--device`` it runs on the
card and raises ``SetupError`` where there is none.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.nn.functional as F

from ..config import resolve_device
from ..ops import probes

#: the reference's probe shape (tools/bw_probe.py:39) and box edge (:116)
TILE_ROWS, HALO_ROWS, REF_TILES, LANES, EDGE = 4096, 160, 6, 128, 141
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def box_shifts(edge: int):
    """The flat strides of an ``edge``^3 box and their negatives, in the
    reference's order (tools/bw_probe.py:95-96)."""
    return (edge * edge, edge, 1, -edge * edge, -edge, -1)


def time_per_call(fn, dev, reps: int) -> float:
    """Seconds per call of ``fn`` over ``reps`` back-to-back calls after
    a warm-up: CUDA events on a card, the host clock on the CPU."""
    for _ in range(3):
        fn()
    if dev.type == "cuda":
        with torch.cuda.device(dev):   # the events on the card's stream
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                fn()
            e1.record()
            e1.synchronize()
        return e0.elapsed_time(e1) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def pad_halo(xb, G, T, H, L):
    """tools/bw_probe.py:121-131 in torch: the box padded to G T L,
    its blocks' halo rows assembled, then unpadded."""
    shape, nbox, n_pad = xb.shape, xb.numel(), G * T * L
    flat = F.pad(xb.reshape(nbox), (0, n_pad - nbox))
    a2 = flat.reshape(G * T, L)
    a3 = a2.reshape(G, T, L)
    z = torch.zeros((1, H, L), dtype=xb.dtype, device=xb.device)
    pv = torch.cat([z, a3[:-1, T - H:, :]], dim=0)
    nx = torch.cat([a3[1:, :H, :], z], dim=0)
    out = (a2 + pv.sum() + nx.sum()).reshape(n_pad)[:nbox]
    return out.reshape(shape) * 0.9999


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m pacmensl_tpu_torch.tools.bw_probe",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tiles", type=int, default=96,
                    help="blocks G of the device-memory shape (default 96)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    T, H, L, E = TILE_ROWS, HALO_ROWS, LANES, EDGE
    reps = 100 if dev.type == "cuda" else 3
    itemsize = torch.empty((), dtype=dtype).element_size()
    if dev.type == "cuda":
        l2 = torch.cuda.get_device_properties(dev).L2_cache_size
        log(f"device: {torch.cuda.get_device_name(dev)}, L2 {l2 / 1e6:.1f} "
            f"MB; dtype {args.dtype}; CUDA events over {reps} calls")
    else:
        l2 = None
        log(f"device: cpu (host clock over {reps} calls, not a device "
            f"number); dtype {args.dtype}")
    shifts = box_shifts(E)
    out = {}
    for G in dict.fromkeys((REF_TILES, args.tiles)):
        n = G * T * L
        x = (torch.arange(n, dtype=dtype, device=dev) * 1e-6).reshape(G * T,
                                                                     L)
        y = torch.empty_like(x)
        hv = torch.zeros((G * H, L), dtype=dtype, device=dev)
        nbytes = n * itemsize
        where = (f"G={G}, {nbytes / 1e6:.1f} MB per buffer"
                 + (", both in L2" if l2 is not None and 2 * nbytes <= l2
                    else ""))
        runs = {
            "torch stream": lambda: torch.mul(x, probes.SCALED_COPY_FACTOR,
                                              out=y),
            "K6 scaled_copy": lambda: probes.scaled_copy(x, out=y),
            "K7 window_copy": lambda: probes.window_copy(1.0, x, hv, hv, G,
                                                         out=y),
            "K8 roll_window": lambda: probes.roll_window(1.0, x, hv, hv, G,
                                                         shifts, out=y),
        }
        for label, fn in runs.items():
            dt = time_per_call(fn, dev, reps)
            out[(label, G)] = dt
            rate = ("" if label.startswith("K8")
                    else f" -> {2 * nbytes / dt / 1e9:8.1f} GB/s")
            log(f"{label:<15}: {dt * 1e6:9.1f} us/call{rate} ({where})")
        del x, y, hv
    # 5) the wrapper's pad + halo assembly, no kernel
    nbox = E ** 3
    xb = (torch.arange(nbox, dtype=dtype, device=dev) * 1e-6).reshape(
        (E,) * 3)
    dt = time_per_call(lambda: pad_halo(xb, REF_TILES, T, H, L), dev, reps)
    out[("torch pad+halo", REF_TILES)] = dt
    log(f"{'torch pad+halo':<15}: {dt * 1e6:9.1f} us/call ({E}^3 box "
        f"padded to G={REF_TILES}, {nbox} elements)")
    return out


if __name__ == "__main__":
    main()
