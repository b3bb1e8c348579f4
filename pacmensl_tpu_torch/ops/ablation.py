"""Ablation builds of the box kernel, for the measurement tools only.

The reference package located its Pallas kernel's cost by rebuilding it
with pieces switched off (``tools/kernel_ablate.py``,
``tools/base_probe.py``).  The port switches a piece of
``csrc/box_action.cu`` off at build time, with a macro that no
production build defines (see the source's "Ablation switches"):

* ``"no-tail"`` (``BOX_ABLATE_NO_TAIL``): the last block does not sum the
  sink slots; the slots' partial rows stay in the launch's scratch.
  :func:`tail_sum` is the tail as the kernel sums, so the tail of the
  partial rows must give the production build's sinks;
* ``"zero-coords"`` (``BOX_ABLATE_ZERO_COORDS``): no decode of the rows'
  in-plane coordinates; every row takes row 0's.  Plain version
  :func:`zero_coords_reference`.

Each build is a library of its own (its flags give it its own file under
``_build/``) with launch counters of its own, so its launches never count
as the production kernel's.  Nothing but the measurement tools imports
this module, so no solver path can load one.  A failed build raises
:class:`~.cuda_build.KernelError`; there is no fallback.  Each wrapper
launches its build on CUDA tensors and runs its plain version on CPU
tensors.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..statespace.box_space import EVAL_CHUNK
from ..statespace.constraints import form_values
from .box_kernel import (CONST_AXIS, FIELD_ROW, THREADS, BoxActionKernel,
                         BoxGeometry, PropTables, box_action_reference,
                         box_action_synth_reference)
from .cuda_build import NVCC_FLAGS
from .stencil import coord_grid

#: the ablation builds by name, and the macro each defines
SWITCHES = {"no-tail": "BOX_ABLATE_NO_TAIL",
            "zero-coords": "BOX_ABLATE_ZERO_COORDS"}


class AblatedBoxKernel(BoxActionKernel):
    """The box kernel built with one ablation switch (:data:`SWITCHES`),
    loaded at first launch, with its own launch counters."""

    def __init__(self, name: str):
        super().__init__(NVCC_FLAGS + (f"-D{SWITCHES[name]}",))
        self.name = name


NO_TAIL = AblatedBoxKernel("no-tail")
ZERO_COORDS = AblatedBoxKernel("zero-coords")


def _whole_box(geom: BoxGeometry) -> None:
    if geom.sharded:
        raise ValueError("the ablation builds take a whole box in one "
                         "launch")


# ----------------------------------------------------------------- no-tail
def tail_sum(part: torch.Tensor) -> torch.Tensor:
    """The sinks from the partial rows ``part [rows, n_c]`` of a single
    launch, summed as the kernel's tail sums them: thread t of 256 adds
    rows t, t + 256, ... in order, then a tree halves the threads."""
    rows, nc = part.shape
    red = torch.zeros((THREADS, nc), dtype=part.dtype, device=part.device)
    for lo in range(0, rows, THREADS):
        blk = part[lo:lo + THREADS]
        red[:blk.shape[0]] = red[:blk.shape[0]] + blk
    w = THREADS // 2
    while w:
        red[:w] = red[:w] + red[w:2 * w]
        w //= 2
    return red[0]


def no_tail(c, p, a, geom: BoxGeometry, bounds=None, mask=None, viol=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the ``"no-tail"`` build: K3 where ``bounds`` are
    given, else K1 on ``mask`` and ``viol``, on a whole box.  Returns
    ``(dp, part)``: the slots' partial rows ``[rows, n_c]``, a view of the
    geometry's scratch that its next launch overwrites.  On CPU tensors
    the plain version: its dp, and its sinks as one partial row."""
    _whole_box(geom)
    mode = "synth" if bounds is not None else "mask"
    if p.device.type == "cuda":
        dp, _ = NO_TAIL.launch(mode, c, p, a, geom, mask=mask, viol=viol,
                               bounds=bounds)
        part, _ = geom.scratch(p.device)
        return dp, part[:geom.nslots * geom.nc].view(geom.nslots, geom.nc)
    if p.device.type != "cpu":
        raise ValueError(f"unsupported device {p.device}")
    dp, sk = (box_action_synth_reference(c, p, a, bounds, geom)
              if mode == "synth"
              else box_action_reference(c, p, mask, a, viol, geom))
    return dp, sk[None, :]


# ------------------------------------------------------------- zero-coords
def source_pad(geom: BoxGeometry) -> int:
    """Elements on each side of ``p`` the ``"zero-coords"`` build may read:
    a source at a flat offset ``-k_r`` from an element of the box."""
    return max((abs(k) for k in geom.kflat), default=0)


def padded_p(p: torch.Tensor, geom: BoxGeometry) -> torch.Tensor:
    """``p`` inside zeros of :func:`source_pad` elements on each side: the
    ``"zero-coords"`` build's input."""
    pad = source_pad(geom)
    buf = torch.zeros(geom.n + 2 * pad, dtype=p.dtype, device=p.device)
    buf[pad:pad + geom.n] = p
    return buf


def _table_at(a: PropTables, r: int, y: torch.Tensor) -> torch.Tensor:
    """a_r at the points ``y [m, S]`` (coordinates outside a table are
    clamped; the caller selects them away)."""
    ax = a.axis[r]
    t = a.tables[r].reshape(-1).to(torch.float64)
    if ax == FIELD_ROW:
        raise ValueError("the zero-coords build takes propensity tables "
                         "only")
    if ax == CONST_AXIS:
        return t[0].expand(y.shape[0])
    return t[y[:, ax].clamp(0, t.numel() - 1)]


def zero_coords_reference(c, pbuf, a, bounds, geom: BoxGeometry
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``"zero-coords"`` build's K3 launch: the box
    action where every element x takes the coordinates z(x) of row 0 of
    its plane (every in-plane axis but the last at 0) for its validity,
    its sources' tests, its propensities and its targets, and reads p at
    its own flat index and at the flat source index ``x - k_r`` of
    ``pbuf`` (:func:`padded_p`)."""
    _whole_box(geom)
    if geom.form is None:
        raise ValueError("the zero-coords build runs the synthesized-mask "
                         "mode, which needs a constraint form")
    c = [float(v) for v in (c.tolist() if torch.is_tensor(c) else c)]
    dev, n, S, pad = pbuf.device, geom.n, len(geom.shape), source_pad(geom)
    a = a if isinstance(a, PropTables) else PropTables.from_fields(
        a, shape=geom.shape)
    b = torch.tensor(np.asarray(bounds, dtype=np.int64), device=dev)
    ext = torch.tensor(geom.shape, device=dev)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    dp = torch.empty(n, dtype=torch.float64, device=dev)
    sinks = [zero] * geom.nc
    for lo in range(0, n, EVAL_CHUNK):
        hi = min(n, lo + EVAL_CHUNK)
        z = coord_grid(geom.shape, dev, lo, hi)
        z[:, 1:S - 1] = 0
        valid = (form_values(geom.form, z) <= b).all(1)
        idx = torch.arange(lo, hi, device=dev) + pad
        pv = pbuf[idx]
        acc = torch.zeros(hi - lo, dtype=torch.float64, device=dev)
        for r in range(geom.num_reactions):
            s = torch.as_tensor(geom.stoich[r], device=dev)[None, :]
            ap = torch.where(valid, _table_at(a, r, z) * pv, zero)
            src = z - s
            ok = (valid & ((src >= 0) & (src < ext)).all(1)
                  & (form_values(geom.form, src) <= b).all(1))
            inflow = torch.where(
                ok, _table_at(a, r, src) * pbuf[idx - geom.kflat[r]], zero)
            acc = acc + c[r] * (inflow - ap)
            over = form_values(geom.form, z + s) > b
            for cc in range(geom.nc):
                sinks[cc] = sinks[cc] + c[r] * torch.where(
                    over[:, cc], ap, zero).sum()
        dp[lo:hi] = acc
    sk = (torch.stack(sinks) if geom.nc
          else torch.zeros(0, dtype=torch.float64, device=dev))
    return dp, sk


def zero_coords(c, pbuf, a, bounds, geom: BoxGeometry
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dp, sinks)`` of one launch of the ``"zero-coords"`` build in the
    synthesized-mask mode on ``pbuf`` (:func:`padded_p`).  CUDA tensors
    launch it; CPU tensors run :func:`zero_coords_reference`."""
    _whole_box(geom)
    pad = source_pad(geom)
    if tuple(pbuf.shape) != (geom.n + 2 * pad,):
        raise ValueError(f"pbuf has shape {tuple(pbuf.shape)}, expected "
                         f"({geom.n + 2 * pad},): p padded by padded_p")
    if pbuf.device.type == "cuda":
        return ZERO_COORDS.launch("synth", c, pbuf[pad:pad + geom.n], a,
                                  geom, bounds=bounds)
    if pbuf.device.type == "cpu":
        return zero_coords_reference(c, pbuf, a, bounds, geom)
    raise ValueError(f"unsupported device {pbuf.device}")
