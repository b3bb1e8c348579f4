"""Ablation timer of the box kernel (the port's counterpart of the
reference package's ``tools/kernel_ablate.py``).

    python -m pacmensl_tpu_torch.tools.kernel_ablate [--shape E0 E1 E2]
        [--device cuda|cpu]

Times the kernel with pieces switched off, by default on the bench box
(``bench.py:78-98``): the repressilator at fixed bounds 127, a 128^3
capacity whose every state is valid, in float64 (the port's default);
``--shape`` takes another capacity of the same box.  The variants:

* ``full``: the path's kernel, K3 (synthesized mask, sinks in the kernel),
  or K1 where the path reads the mask;
* ``r1``, ``r2``: the same on the first one and two reactions
  (``BoxOperator(enable_reactions=[0])`` and ``[0, 1]``);
* ``nosink``: K1 with no constraint, so no sink work at all (the
  reference's ``components=None``), on violation words of zeros;
* ``unitnosink``: ``nosink`` with every propensity a one-entry table of
  1.0 (``CONST_AXIS``);
* ``full-K1`` (K3 paths): K1 on the same box and constraints, the mask's
  read against K3's synthesis;
* ``no-tail``: ``full`` from the build whose last block leaves the sink
  slots unsummed (``ops/ablation.py``).

Each variant is first checked against its plain version (dp bitwise,
sinks within rtol 1e-12 / atol 1e-13; ``no-tail``: its dp bitwise and the
tail of its slots within 1e-12 of ``full``'s sinks) and a mismatch fails
the run.  Then the variants are timed in turns, each round ``full``, the
variants, the variants in reverse, ``full``: CUDA events around 200
back-to-back launches after 10 warm-ups, three rounds, and a CUDA
graph replay of 100 launches (the device's time without the host's cost).
One line per variant: the median and the range of its timings, the graph
replay, Gnnz/s counted as the reference counts them (``n (R + 1)``), and
the bound of the variant's compulsory bytes (``ops.probes.box_action_bytes``
over ``ops.probes.HBM_RATE``) with the share of it reached.  The first line gives the
card's name and power limit.  Without a card it raises ``SetupError``;
``--device cpu`` runs the plain versions at a 16^3 box under the host
clock (a host number, not a device one).
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from ..config import resolve_device
from ..models import library
from ..models.model import Model
from ..ops import ablation
from ..ops import box_kernel as bk
from ..ops import box_operator as bo
from ..ops import probes
from ..statespace.constraints import ConstraintSet
from .timing import card, graph_ms, time_ms

#: the bench box's edge on a card and on the host
EDGE, CPU_EDGE = 128, 16
#: launches a CUDA-event timing takes, and rounds of timings, on a card
REPS, ROUNDS = 200, 3
#: launches a CUDA graph replays
GRAPH_REPS = 100
#: the kernel against its plain version
TOL = dict(rtol=1e-12, atol=1e-13)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class Case(NamedTuple):
    """One box the tools time: the model, its capacity, the constraints at
    the epoch's bounds, the mask (``[n]`` uint8), ``p``, the time at which
    the coefficients are taken, and whether the path runs K3."""
    label: str
    model: Model
    shape: tuple
    constraints: ConstraintSet
    mask: torch.Tensor
    p: torch.Tensor
    t: float
    synth: bool

    @property
    def n(self) -> int:
        return int(np.prod(self.shape))

    @property
    def n_valid(self) -> int:
        return int((self.mask != 0).sum())

    def to(self, dev) -> "Case":
        """The case with its mask and ``p`` on ``dev``."""
        return self._replace(mask=self.mask.to(dev), p=self.p.to(dev))


def bench_case(shape, dev, seed: int = 1234) -> Case:
    """The repressilator at fixed bounds ``shape - 1`` (every state of
    the box valid), ``p`` uniform from a numpy seed."""
    rep = library.repressilator()
    shape = tuple(int(e) for e in shape)
    cs = ConstraintSet(None, np.asarray(shape) - 1, None, len(shape))
    n = int(np.prod(shape))
    p = torch.as_tensor(np.random.default_rng(seed).random(n), device=dev)
    return Case("x".join(map(str, shape)) + " repressilator box", rep.model,
                shape, cs, torch.ones(n, dtype=torch.uint8, device=dev), p,
                0.0, True)


def operator_case(label: str, op, p, t: float) -> Case:
    """``op`` (a :class:`~..ops.box_operator.BoxOperator` of a solve) with
    the vector ``p`` at time ``t``."""
    return Case(label, op.model, tuple(op.shape), op.space.constraints,
                op.space.mask.reshape(-1).to(torch.uint8), p, float(t),
                bool(op.synth_mask))


class Parts(NamedTuple):
    """A kernel's inputs for some reactions of a case, as
    ``BoxOperator(enable_reactions=...)`` builds them."""
    geom: bk.BoxGeometry
    props: bk.PropTables
    c: torch.Tensor
    bounds: np.ndarray
    synth: bool


def parts(case: Case, reactions=None, constraints: bool = True,
          unit: bool = False) -> Parts:
    """The geometry, propensities and coefficients of ``reactions`` (all
    by default) of ``case``; ``constraints=False``: no constraint (no
    sinks, K1); ``unit``: every propensity a one-entry table of 1.0."""
    model, dev = case.model, case.p.device
    rs = list(range(model.num_reactions) if reactions is None
              else reactions)
    stoich = np.atleast_2d(model.stoichiometry[rs])
    cs = case.constraints
    nc = cs.num_constraints if constraints else 0
    form = cs.form if constraints else None
    if form is not None and not bk.form_fits_kernel(form, stoich):
        form = None
    geom = bk.BoxGeometry(case.shape, stoich, nc, form)
    if unit:
        one = torch.ones(1, dtype=torch.float64, device=dev)
        props = bk.PropTables(case.shape, (bk.CONST_AXIS,) * len(rs),
                              [one] * len(rs))
    else:
        props = bo.propensity_tables(model, case.shape, dev, reactions=rs)
    c = model.coefficients(case.t)[rs]
    synth = case.synth and constraints and geom.masks is not None
    return Parts(geom, props, c, np.asarray(cs.bounds), synth)


class Variant(NamedTuple):
    """A launch and its plain version (each returning ``(dp, sinks)``;
    ``no-tail``: ``(dp, partial rows)``), with what its bound counts."""
    run: Callable
    plain: Callable
    R: int
    synth: bool
    props: bk.PropTables


def _viol(case: Case, pa: Parts, zero: bool = False) -> torch.Tensor:
    R, dev = pa.geom.num_reactions, case.p.device
    if zero:
        return torch.zeros((R, case.n), dtype=torch.int32, device=dev)
    return bo.violation_bits(case.constraints, pa.geom.stoich, case.shape,
                             dev)


def _kernel(case: Case, pa: Parts, synth: bool, viol=None) -> Variant:
    p, m = case.p, case.mask
    if synth:
        def run():
            return bk.box_action_synth(pa.c, p, pa.props, pa.bounds,
                                       pa.geom)

        def plain():
            return bk.box_action_synth_reference(pa.c, p, pa.props,
                                                 pa.bounds, pa.geom)
    else:
        viol = _viol(case, pa) if viol is None else viol

        def run():
            return bk.box_action(pa.c, p, m, pa.props, viol, pa.geom)

        def plain():
            return bk.box_action_reference(pa.c, p, m, pa.props, viol,
                                           pa.geom)
    return Variant(run, plain, pa.geom.num_reactions, synth, pa.props)


def path_variants(case: Case, full: Parts) -> Dict[str, Variant]:
    """``full`` (the path's kernel on every reaction of ``case``, whose
    parts are ``full``) and, where the case has constraints, ``no-tail``
    (the same from the build without the sinks' tail)."""
    viol = None if full.synth else _viol(case, full)
    out = {"full": _kernel(case, full, full.synth, viol)}
    if full.geom.nc:
        b = full.bounds if full.synth else None
        out["no-tail"] = Variant(
            lambda: ablation.no_tail(full.c, case.p, full.props, full.geom,
                                     b, case.mask, viol),
            out["full"].plain, full.geom.num_reactions, full.synth,
            full.props)
    return out


def variants(case: Case) -> Dict[str, Variant]:
    """The variants of ``case``, in the order they are reported."""
    full = parts(case)
    path = path_variants(case, full)
    out = {"full": path.pop("full")}
    for name, rs in (("r1", [0]), ("r2", [0, 1])):
        if case.model.num_reactions > len(rs):
            pa = parts(case, rs)
            out[name] = _kernel(case, pa, pa.synth)
    bare = parts(case, constraints=False)
    zero = _viol(case, bare, zero=True)
    out["nosink"] = _kernel(case, bare, False, zero)
    out["unitnosink"] = _kernel(case, parts(case, constraints=False,
                                            unit=True), False, zero)
    if full.synth:
        out["full-K1"] = _kernel(case, full, False)
    out.update(path)
    return out


def check_variant(name: str, v: Variant, tail_of=None) -> float:
    """``v`` launched twice (bitwise equal, finite) against its plain
    version: dp bitwise, sinks within rtol 1e-12 / atol 1e-13; with
    ``tail_of`` (the path's sinks) ``v`` is the no-tail build, and the
    tail of its partial rows is held against them.  A mismatch raises;
    returns the largest difference."""
    def launch():
        dp, sk = v.run()
        return (dp, sk) if tail_of is None else (dp, ablation.tail_sum(sk))
    got, again, want = launch(), launch(), v.plain()
    if tail_of is not None:
        want = (want[0], tail_of)
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise AssertionError(f"{name}: two launches differ")
    if not (bool(torch.isfinite(got[0]).all())
            and bool(torch.isfinite(got[1]).all())):
        raise AssertionError(f"{name}: non-finite output")
    err = float(max((got[0] - want[0]).abs().max(),
                    (got[1] - want[1]).abs().max() if want[1].numel()
                    else 0.0))
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"{name}: dp is not bitwise its plain "
                             f"version's (max abs {err:.3e})")
    if not torch.allclose(got[1], want[1], **TOL):
        raise AssertionError(f"{name}: sinks differ by {err:.3e}")
    return err


def time_in_turns(runs: Dict[str, Callable], cuda: bool, reps: int,
                  rounds: int) -> Dict[str, dict]:
    """Times ``runs`` in turns, each round in order and then in reverse:
    on a card CUDA events around ``reps`` launches after 10 warm-ups,
    ``rounds`` rounds, and a CUDA graph of :data:`GRAPH_REPS` launches;
    on the host one call a turn on the host clock.  Returns ``{run:
    {"us" (the median), "lo", "hi", "graph_us", "text"}}``."""
    order = list(runs)
    times = {k: [] for k in order}
    for _ in range(rounds):
        for k in order + order[::-1]:
            if cuda:
                times[k].append(time_ms(runs[k], reps, 10))
            else:
                t0 = time.perf_counter()
                runs[k]()
                times[k].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for k, t in times.items():
        r = {"us": statistics.median(t) * 1e3, "lo": min(t) * 1e3,
             "hi": max(t) * 1e3,
             "graph_us": graph_ms(runs[k], GRAPH_REPS) * 1e3 if cuda
             else None}
        r["text"] = (f"{r['us']:.1f} us (CUDA events, median of {len(t)} "
                     f"runs of {reps}: {r['lo']:.1f}-{r['hi']:.1f}), graph "
                     f"{r['graph_us']:.1f} us" if cuda else
                     f"{r['us']:.1f} us on the host clock (the plain "
                     "version)")
        out[k] = r
    return out


def ablate(case: Case, smi: str, reps: int = REPS, rounds: int = ROUNDS,
           out=log) -> Dict[str, dict]:
    """Checks and times every variant of ``case`` (see the module's
    docstring); prints one line per variant through ``out``.  Returns
    ``{variant: {"us", "lo", "hi", "graph_us", "text", "gnnz",
    "bound_us", "share", "err"}}`` (:func:`time_in_turns`; on the CPU the
    host clock's)."""
    dev = case.p.device
    vs = variants(case)
    full_sinks = vs["full"].run()[1]
    errs = {k: check_variant(k, v, full_sinks if k == "no-tail" else None)
            for k, v in vs.items()}
    cuda = dev.type == "cuda"
    res = time_in_turns({k: v.run for k, v in vs.items()}, cuda, reps,
                        rounds)
    n, R = case.n, case.model.num_reactions
    out(f"[kernel_ablate] {case.label} {case.shape} ({n} elements, "
        f"{case.n_valid} valid, path {'K3' if case.synth else 'K1'}); "
        f"{smi}")
    for k, v in vs.items():
        r = res[k]
        nbytes = probes.box_action_bytes(
            n, n, v.R, v.synth, n_valid=case.n_valid,
            table_bytes=v.props.table_bytes(),
            field_rows=v.props.num_field_rows)
        r.update(bound_us=nbytes / probes.HBM_RATE * 1e6,
                 gnnz=n * (R + 1) / r["us"] / 1e3, err=errs[k])
        r["share"] = r["bound_us"] / r["us"]
        out(f"[kernel_ablate] {case.label} {k:<10} "
            f"{'K3' if v.synth else 'K1'} R={v.R}: {r['text']}, "
            f"{r['gnnz']:.2f} Gnnz/s, bound {r['bound_us']:.1f} us "
            f"({nbytes / 1e6:.1f} MB), {r['share']:.3f} of it, max abs err "
            f"{r['err']:.3e}")
    return res


def main(argv=None, out=log) -> Dict[str, dict]:
    """The command line; ``out`` takes the lines (stderr by default)."""
    ap = argparse.ArgumentParser(
        prog="python -m pacmensl_tpu_torch.tools.kernel_ablate",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--shape", type=int, nargs=3, default=None,
                    help="the box's capacity (default 128 128 128; 16^3 "
                         "on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    edge = EDGE if dev.type == "cuda" else CPU_EDGE
    shape = tuple(args.shape) if args.shape else (edge,) * 3
    smi = card(dev)
    out(f"[kernel_ablate] card: {smi}")
    return ablate(bench_case(shape, dev), smi, out=out)


if __name__ == "__main__":
    main()
