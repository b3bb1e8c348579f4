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
* Halos in flight, where ``L0 >= 2 w0`` and ``PACMENSL_HALO_OVERLAP`` is
  not ``"0"`` (reference ``:149-193``): the exchange starts first, one
  launch computes the interior rows ``[w0, L0 - w0)``, which need no
  remote planes, while it is in flight, and one launch computes both edge
  strips (the first and the last ``w0`` rows) from the received halos.
  The second launch sums both launches' sink partials: one reduction per
  matvec.
* Else one launch on the window after the exchange.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.box_kernel import BoxGeometry, box_action, box_action_synth
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

        def geom(out, gap=None, follows=None):
            return BoxGeometry(self.window_shape, stoichiometry,
                               num_constraints, form, origin0=lo - w0,
                               g0=self.shape[0], out_rows=out, gap=gap,
                               halo_rows=(w0, L0), follows=follows)

        #: whether a halo crosses ranks; without, no exchange and no
        #: collective
        self.halos = mesh.size > 1
        self.overlap = (self.halos and L0 >= 2 * w0
                        and os.environ.get("PACMENSL_HALO_OVERLAP", "1")
                        != "0")
        if self.overlap:
            self.geom_int = geom((2 * w0, L0))
            self.geom_edge = geom((w0, w0 + L0), gap=(2 * w0, L0),
                                  follows=self.geom_int)
        else:
            self.geom = geom((w0, w0 + L0))
        self._up = self._dn = None
        if self.halos:
            self._up = torch.zeros(w0 * P, dtype=torch.float64,
                                   device=mesh.device)
            self._dn = torch.zeros(w0 * P, dtype=torch.float64,
                                   device=mesh.device)

    def _run(self, geom, c, p, a, mask, viol, bounds, out=None, halos=None):
        """The kernel on ``geom``, a window of the operator's data."""
        if mask is None:
            return box_action_synth(c, p, a, bounds, geom, out, halos)
        return box_action(c, p, mask, a, viol, geom, out, halos)

    def __call__(self, c, p, a, mask: Optional[torch.Tensor],
                 viol: Optional[torch.Tensor], bounds
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        w0, L0, P = self.w0, self.L0, self.plane
        if not self.halos:
            return self._run(self.geom, c, p, a, mask, viol, bounds)
        ex = self.mesh.halo_start(p[:w0 * P], p[(L0 - w0) * P:], self._up,
                                  self._dn)
        if self.overlap:
            dp = torch.empty_like(p)
            self._run(self.geom_int, c, p, a, mask, viol, bounds,
                      dp[w0 * P:(L0 - w0) * P])
            halos = ex.wait()
            _, ks = self._run(self.geom_edge, c, p, a, mask, viol, bounds,
                              dp, halos)
        else:
            halos = ex.wait()
            dp, ks = self._run(self.geom, c, p, a, mask, viol, bounds,
                               halos=halos)
        if ks.numel():
            self.mesh.all_reduce(ks)
        return dp, ks

    def comm_values_per_matvec(self) -> int:
        """Values of ``p`` crossing ranks per matvec, over all ranks: two
        halos of ``w0`` planes at each of the ``size - 1`` slab
        boundaries.  The reference counts the mask's planes too; here
        only ``p`` crosses."""
        return 2 * self.w0 * self.plane * (self.mesh.size - 1)
