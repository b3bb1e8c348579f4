"""Sharded box action: halo exchange plus the box kernel's sharded mode.

Counterpart of ``pacmensl_tpu/parallel/halo_box.py``
(``ShardedPallasBoxAction``), the equivalent of the reference's
MatMult-with-VecScatter-halo hot loop (``src/Matrix/FspMatrixBase.cpp:
36-62``).  The box is split into axis-0 slabs of ``L0`` planes, one per
rank.  Before the kernel, each rank sends its first ``w0`` planes of ``p``
to rank - 1 and its last ``w0`` to rank + 1 (the ends of the box get
zeros), runs the box kernel's sharded mode (K4, ``ops/box_kernel.py``) on
its slab extended by the two halos, with axis 0 in global coordinates,
and all-reduces the sinks, which each rank counts on its own rows only.
``w0 = max_r |s_r[0]| + 1`` planes, the reference's halo width.

Only ``p`` crosses ranks.  Every rank holds the whole state space (bounds,
mask), so the mask and the violation bits of its window are sliced from
its own data, where the reference exchanges the mask too
(``halo_box.py:140, 162-165``).

The kernel reads the window's ``p`` through three base pointers (the halo
above, the rank's slab, the halo below), so no window is ever
concatenated, and the halos are received into buffers allocated once.

* One rank (no neighbour on either side): one launch on the slab, with no
  halos (the rows they would hold lie outside the box), and no
  collective.
* Several ranks: one launch on the window after the exchange (K4).  The
  reference overlaps the exchange with a launch on the interior rows
  (``:149-193``); the port takes one launch after the exchange because it
  measured faster (``PERF.md`` section 6).

:meth:`ShardedBoxAction.batched` applies the action to ``nb`` vectors of
the rank's slab at once (the reference's meshed sensitivity solve
``vmap``s the sharded call): one exchange of every vector's edge planes,
stacked ``[nb, w0 P]`` each way, the batched kernel in one launch on the
window (K9w), and one all-reduce of the ``[nb, n_c]`` sinks.
:meth:`ShardedBoxAction.apply` is the action on either, given halos that
another action received (``halos=``, planes of a width of at least
``w0``: then no exchange) and with the sinks left unreduced on request
(``reduce=False``), so that a sensitivity action makes one exchange and
one all-reduce for all its operators (``ops/sens_operator.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.box_kernel import (BoxGeometry, box_action, box_action_batched,
                              box_action_synth, box_action_synth_batched)
from ..sys.errors import SetupError
from .mesh import StateMesh, slab_rows


def halo_width(stoichiometry) -> int:
    """``w0 = max_r |s_r[0]| + 1`` axis-0 planes."""
    s = np.atleast_2d(np.asarray(stoichiometry, np.int64))
    return int(np.abs(s[:, 0]).max(initial=0)) + 1


def window_rows(box: torch.Tensor, origin0: int, rows: int) -> torch.Tensor:
    """Rows ``[origin0, origin0 + rows)`` of a box-shaped tensor, zero
    where they lie outside it (box-shaped, ``rows`` planes)."""
    out = torch.zeros((rows,) + tuple(box.shape[1:]), dtype=box.dtype,
                      device=box.device)
    lo, hi = max(origin0, 0), min(origin0 + rows, box.shape[0])
    if hi > lo:
        out[lo - origin0:hi - origin0] = box[lo:hi]
    return out


class ShardedBoxAction:
    """``(c, p_loc, a, mask, viol, bounds) -> (dp_loc, sinks)`` on this
    rank's slab of the box ``shape``.  ``a``, ``mask`` and ``viol`` are
    the operator's data over the rank's window of ``L0 + 2 w0`` planes
    (window row 0 at global row ``origin0``); ``mask`` and ``viol`` are
    None in the synthesized-mask mode."""

    def __init__(self, shape, stoichiometry, num_constraints: int, form,
                 mesh: StateMesh):
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)
        self.w0 = w0 = halo_width(stoichiometry)
        lo, hi = slab_rows(self.shape, mesh)
        self.L0 = L0 = hi - lo
        if L0 < w0:
            raise SetupError(
                f"slabs of {L0} axis-0 planes ({self.shape[0]} over "
                f"{mesh.size} ranks) are thinner than the halo of "
                f"w0 = {w0} planes; use fewer ranks")
        self.plane = P = int(np.prod(self.shape[1:]))
        self.origin0 = lo - w0
        self.window_shape = (L0 + 2 * w0,) + self.shape[1:]
        #: whether a halo crosses ranks; without, no exchange and no
        #: collective
        self.halos = mesh.size > 1
        #: one launch on the window: K4 and K9w
        self.geom = BoxGeometry(self.window_shape, stoichiometry,
                                num_constraints, form, origin0=lo - w0,
                                g0=self.shape[0], out_rows=(w0, w0 + L0),
                                halo_rows=(w0, L0))
        # the received halos, per leading shape of p: () or (nb,)
        self._bufs = {}

    def _run(self, c, p, a, mask, viol, bounds, out=None, halos=None):
        """The kernel on the window of the operator's data: K4 on a
        vector ``p``, K9w on a batch ``[nb, L0 P]``."""
        geom = self.geom
        if p.dim() == 2:
            if mask is None:
                return box_action_synth_batched(c, p, a, bounds, geom, out,
                                                halos)
            return box_action_batched(c, p, mask, a, viol, geom, out, halos)
        if mask is None:
            return box_action_synth(c, p, a, bounds, geom, out, halos)
        return box_action(c, p, mask, a, viol, geom, out, halos)

    def apply(self, c, p, a, mask: Optional[torch.Tensor],
              viol: Optional[torch.Tensor], bounds, out=None, halos=None,
              reduce: bool = True):
        """``(dp, sinks, halos)`` of the action on the rank's slab ``p``
        (``[L0 P]``, or ``[nb, L0 P]``: the slab of each vector), the
        halos as the kernel read them (None on one rank).  ``halos = (up,
        dn)``: planes above and below the slab that another action's
        exchange received, at least ``w0`` wide (then no exchange);
        ``reduce=False`` leaves this rank's partial sinks; ``out``: where
        to write ``dp``."""
        w0, L0, P = self.w0, self.L0, self.plane
        if not self.halos:
            dp, ks = self._run(c, p, a, mask, viol, bounds, out)
            return dp, ks, None
        ex = None
        if halos is None:
            bufs = self._bufs.get(p.shape[:-1])
            if bufs is None:
                bufs = self._bufs[p.shape[:-1]] = tuple(
                    torch.zeros(p.shape[:-1] + (w0 * P,),
                                dtype=torch.float64, device=p.device)
                    for _ in range(2))
            ex = self.mesh.halo_start(p[..., :w0 * P],
                                      p[..., (L0 - w0) * P:], *bufs)
        else:
            # the planes next to the slab, of halos at least w0 planes wide
            up, dn = halos
            halos = (up[..., up.shape[-1] - w0 * P:], dn[..., :w0 * P])
        if ex is not None:
            halos = ex.wait()
        dp, ks = self._run(c, p, a, mask, viol, bounds, out, halos)
        if reduce and ks.numel():
            self.mesh.all_reduce(ks)
        return dp, ks, halos

    def __call__(self, c, p, a, mask: Optional[torch.Tensor],
                 viol: Optional[torch.Tensor], bounds
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(dp [L0 P], sinks [n_c])`` of the action on the rank's slab
        ``p``: one halo exchange, K4, one all-reduce of the sinks."""
        dp, ks, _ = self.apply(c, p, a, mask, viol, bounds)
        return dp, ks

    def batched(self, c, p, a, mask: Optional[torch.Tensor],
                viol: Optional[torch.Tensor], bounds, out=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(dp [nb, L0 P], sinks [nb, n_c])`` of the action on each row
        of ``p [nb, L0 P]`` (the rank's slab of each vector): one halo
        exchange of every vector's edge planes, one K9w launch, one
        all-reduce of the sinks.  ``out``: where to write ``dp``."""
        dp, ks, _ = self.apply(c, p, a, mask, viol, bounds, out)
        return dp, ks

    def comm_values_per_matvec(self) -> int:
        """Values of ``p`` crossing ranks per matvec, over all ranks: two
        halos of ``w0`` planes at each of the ``size - 1`` slab
        boundaries.  The reference counts the mask's planes too; here
        only ``p`` crosses."""
        return 2 * self.w0 * self.plane * (self.mesh.size - 1)
