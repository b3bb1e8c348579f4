"""Split a box-kernel launch's fixed cost (the port's counterpart of the
reference package's ``tools/base_probe.py``).

    python -m pacmensl_tpu_torch.tools.base_probe [--shape E0 E1 E2]
        [--device cuda|cpu]

Three parts, by default on ``kernel_ablate``'s bench box (128^3):

1. **The host side**: a K1 and a K3 launch's host time (1,000 calls
   without a synchronisation), and what a K3 launch's is made of (the C
   launch through ``ctypes``, ``BoxGeometry.params``, ``torch.empty``,
   ``model.coefficients(t)``), on hog1p_5d's small box, where the card
   keeps up with the host.  The reference's pad, unpad and halo rows
   (``tools/base_probe.py:87-106``) are the TPU's ``[rows, 128]`` layout,
   which the port does not have: these parts are their counterpart.
2. **The device side**: the path's kernel against the ablation builds
   (``ops/ablation.py``) without the decode of the rows' coordinates
   (``zero-coords``, K3 paths on propensity tables where every element of
   the box is valid, since the build gives every row row 0's valid
   elements; the counterpart of the reference's ``ZERO_COORDS``) and without the sinks' tail
   (``no-tail``).  The reference's ``frc-coords`` candidate (a float
   reciprocal in place of the division, ``tools/base_probe.py:124-159``)
   is how the port decodes already: a multiply and a shift a row and axis.
3. **The kernel's floor**: K1 at the same box with an all-zero mask
   (every row only writes zeros), and K1 on a box of one row, also from
   the build without the tail.

Every launch is first checked against its plain version (``zero-coords``:
:func:`~..ops.ablation.zero_coords_reference`; ``no-tail``: the tail of
its slots against the path's sinks) and a mismatch fails the run.  Times
are taken in turns (CUDA events around 200 launches after 10
warm-ups, three rounds; the median and the range) and from a CUDA
graph of 100 launches.  The first line gives the card's name and power
limit.  Without a card it raises ``SetupError``; ``--device cpu`` runs
the plain versions at a 16^3 box under the host clock (host numbers).
"""
from __future__ import annotations

import argparse
import ctypes
import time
from typing import Dict

import numpy as np
import torch

from ..config import resolve_device
from ..models import library
from ..ops import ablation
from ..ops import box_kernel as bk
from ..ops import box_operator as bo
from ..statespace.box_space import BoxStateSpace
from ..statespace.constraints import ConstraintSet
from .kernel_ablate import (CPU_EDGE, EDGE, REPS, ROUNDS, Case, Variant,
                            bench_case, check_variant, log, parts,
                            path_variants, time_in_turns)
from .timing import card

#: the host side's box: hog1p_5d at small bounds (a few thousand elements)
HOST_BOUNDS, HOST_T = [3, 6, 6, 6, 6, 8, 8], 60.0


def host_operator(dev) -> bo.BoxOperator:
    """hog1p_5d's operator at :data:`HOST_BOUNDS` on ``dev``."""
    b = library.hog1p_5d()
    cs = ConstraintSet(b.constraint, np.asarray(HOST_BOUNDS),
                       b.expansion_factors, b.model.num_species)
    space = BoxStateSpace(b.model.stoichiometry, cs, b.x0, device=dev)
    return bo.BoxOperator(b.model, space)


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls without a
    synchronisation (on a box small enough that the device keeps up)."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    for _ in range(10):
        fn()
    sync()
    t1 = time.perf_counter()
    for _ in range(calls):
        fn()
    t2 = time.perf_counter()
    sync()
    return (t2 - t1) * 1e6 / calls


def host_side(op: bo.BoxOperator, t: float = HOST_T):
    """The host microseconds of a K1 and a K3 launch on ``op`` (a CUDA
    operator), and of a K3 launch's parts.  Returns ``({"K1", "K3"},
    {part: us}, the parameter struct's bytes)``.  The bare C launch
    writes into the outputs of a wrapper call it keeps."""
    dev = op.device
    mask = op.space.mask.reshape(-1).to(torch.uint8)
    viol = bo.violation_bits(op.space.constraints, op.model.stoichiometry,
                             op.shape, dev)
    one, zero = (torch.ones((), device=dev, dtype=torch.float64),
                 torch.zeros((), device=dev, dtype=torch.float64))
    p = torch.where(mask != 0, one, zero)
    c, g, b = op.model.coefficients(t), op.geom, op.data().bounds
    launch = {"K1": host_us(lambda: bk.box_action(c, p, mask, op.props,
                                                  viol, g)),
              "K3": host_us(lambda: bk.box_action_synth(c, p, op.props, b,
                                                        g))}
    keep = bk.box_action_synth(c, p, op.props, b, g)
    lib, prm = bk.KERNEL.load(), g.params(c, b, op.props)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    narrow, tiny = int(g.narrow(b)), torch.zeros(16, device=dev)
    parts_ = {
        "the C launch through ctypes": lambda: lib.box_action_launch(
            ctypes.byref(prm), ctypes.byref(g._ptrs), g.nblocks, 1, narrow,
            dev.index, stream),
        "a trivial ctypes call": lib.box_action_threads,
        "one tiny PyTorch kernel": lambda: tiny.add_(1.0),
        "torch.empty": lambda: torch.empty(g.n_out + g.nc,
                                           dtype=torch.float64, device=dev),
        "BoxGeometry.params": lambda: g.params(c, b, op.props),
        "model.coefficients(t)": lambda: op.model.coefficients(t)}
    us = {k: host_us(f) for k, f in parts_.items()}
    del keep
    return launch, us, ctypes.sizeof(prm)


def host_side_text(op, launch, us, size) -> str:
    """:func:`host_side`'s result as the two lines ``chip_smoke.py``'s
    phase 2 prints."""
    return (f"host time per launch (hog1p_5d box {op.shape}, 1000 calls "
            f"without a synchronisation): K1 {launch['K1']:.1f} us, K3 "
            f"{launch['K3']:.1f} us\nhost time of a K3 launch's parts (us "
            f"per call, parameter struct {size} B): " + ", ".join(
                f"{k} {v:.2f}" for k, v in us.items()))


def device_side(case: Case, smi: str, reps: int = REPS,
                rounds: int = ROUNDS, out=log) -> Dict[str, dict]:
    """The device side and the floor of ``case`` (see the module's
    docstring), checked and timed; prints one line per launch through
    ``out`` and the pieces' costs.  Returns ``{launch: {"us", "lo", "hi",
    "graph_us", "text"}}`` (``kernel_ablate.time_in_turns``)."""
    dev, cuda = case.p.device, case.p.device.type == "cuda"
    full = parts(case)
    vs = path_variants(case, full)
    # the zero-coords build gives every row row 0's valid elements: the
    # same work as the path's only where every element is valid
    tables = full.synth and full.props.num_field_rows == 0
    zc = tables and case.n_valid == case.n
    if zc:
        pbuf = ablation.padded_p(case.p, full.geom)
        vs["zero-coords"] = Variant(
            lambda: ablation.zero_coords(full.c, pbuf, full.props,
                                         full.bounds, full.geom),
            lambda: ablation.zero_coords_reference(
                full.c, pbuf, full.props, full.bounds, full.geom),
            full.geom.num_reactions, True, full.props)
    # the floor: K1 with no valid element, and K1 on a box of one row
    viol0 = torch.zeros((full.geom.num_reactions, case.n), dtype=torch.int32,
                        device=dev)
    none = torch.zeros(case.n, dtype=torch.uint8, device=dev)
    vs["K1, zero mask"] = Variant(
        lambda: bk.box_action(full.c, case.p, none, full.props, viol0,
                              full.geom),
        lambda: bk.box_action_reference(full.c, case.p, none, full.props,
                                        viol0, full.geom),
        full.geom.num_reactions, False, full.props)
    E = case.shape[-1]
    row = Case(case.label, case.model, (1,) * (len(case.shape) - 1) + (E,),
               case.constraints, torch.ones(E, dtype=torch.uint8,
                                            device=dev),
               case.p[:E].contiguous(), case.t, False)
    for k, v in path_variants(row, parts(row)).items():
        vs["K1, one row" + ("" if k == "full" else ", no tail")] = v
    for k, v in vs.items():
        tail = k in ("no-tail", "K1, one row, no tail")
        check_variant(k, v, (vs["full" if k == "no-tail" else "K1, one row"]
                             .run()[1]) if tail else None)
    runs = {k: v.run for k, v in vs.items()}
    res = time_in_turns(runs, cuda, reps, rounds)
    out(f"[base_probe] {case.label} {case.shape} ({case.n} elements, "
        f"{case.n_valid} valid, path {'K3' if case.synth else 'K1'}); "
        f"{smi}")
    for k, r in res.items():
        out(f"[base_probe] {case.label} {k:<14}: {r['text']}")
    key = "graph_us" if cuda else "us"
    unit = "us from the graphs" if cuda else "us on the host clock"
    pieces = [f"the tail {res['full'][key] - res['no-tail'][key]:.1f}"
              if "no-tail" in res else "no tail (no constraint)"]
    pieces.append(
        f"the decode {res['full'][key] - res['zero-coords'][key]:.1f}" if zc
        else "the decode: not timed (" + (
            "rows differ in validity" if tables else "the zero-coords build "
            "runs K3 on propensity tables only") + ")")
    out(f"[base_probe] {case.label} pieces ({unit}): " + ", ".join(pieces)
        + f"; floor: zero mask {res['K1, zero mask'][key]:.1f}, one row "
        f"{res['K1, one row'][key]:.1f}"
        + (f" ({res['K1, one row, no tail'][key]:.1f} without the tail)"
           if "K1, one row, no tail" in res else "")
        + ".  The reference's frc-coords "
        "candidate is the port's decode (a multiply and a shift), not "
        "timed again")
    return res


def main(argv=None, out=log) -> Dict[str, dict]:
    """The command line; ``out`` takes the lines (stderr by default)."""
    ap = argparse.ArgumentParser(
        prog="python -m pacmensl_tpu_torch.tools.base_probe",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--shape", type=int, nargs=3, default=None,
                    help="the box's capacity (default 128 128 128; 16^3 "
                         "on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    smi = card(dev)
    out(f"[base_probe] card: {smi}")
    op = host_operator(dev)
    if dev.type == "cuda":
        for line in host_side_text(op, *host_side(op)).split("\n"):
            out(f"[base_probe] {line}")
    else:
        c, g, b = op.model.coefficients(HOST_T), op.geom, op.data().bounds
        out(f"[base_probe] host time of a K3 launch's host parts on the "
            f"host (us per call; no card, no launch): BoxGeometry.params "
            f"{host_us(lambda: g.params(c, b, op.props)):.2f}, "
            f"model.coefficients(t) "
            f"{host_us(lambda: op.model.coefficients(HOST_T)):.2f}")
    edge = EDGE if dev.type == "cuda" else CPU_EDGE
    shape = tuple(args.shape) if args.shape else (edge,) * 3
    return device_side(bench_case(shape, dev), smi, out=out)


if __name__ == "__main__":
    main()
