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

Overlap split (reference ``:149-193``), where ``L0 >= 2 w0`` and
``PACMENSL_HALO_OVERLAP`` is not ``"0"``: the exchange starts first, the
interior rows ``[w0, L0 - w0)``, which need no remote planes, run on the
local slab while it is in flight, and then two strips of ``3 w0`` planes
compute the first and the last ``w0`` rows.  Else one launch on the
``L0 + 2 w0`` window computes the slab after the exchange.
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
        self.plane = int(np.prod(self.shape[1:]))
        self.origin0 = lo - w0
        self.window_shape = (L0 + 2 * w0,) + self.shape[1:]

        def geom(rows, origin0, out):
            return BoxGeometry((rows,) + self.shape[1:], stoichiometry,
                               num_constraints, form, origin0=origin0,
                               g0=self.shape[0], out_rows=out)

        self.overlap = (os.environ.get("PACMENSL_HALO_OVERLAP", "1") != "0"
                        and L0 >= 2 * w0)
        if self.overlap:
            self.geom_int = geom(L0, lo, (w0, L0 - w0))
            self.geom_top = geom(3 * w0, lo - w0, (w0, 2 * w0))
            self.geom_bot = geom(3 * w0, lo + L0 - 2 * w0, (w0, 2 * w0))
        else:
            self.geom = geom(L0 + 2 * w0, lo - w0, (w0, w0 + L0))

    def _run(self, geom, c, p, a, mask, viol, bounds, row0, out=None):
        """The kernel on ``geom``, a window of the operator's data from
        its row ``row0``."""
        P = self.plane
        cols = slice(row0 * P, row0 * P + geom.n)
        if mask is None:
            return box_action_synth(c, p, a[:, cols], bounds, geom, out)
        return box_action(c, p, mask[cols], a[:, cols], viol[:, cols],
                          geom, out)

    def __call__(self, c, p, a, mask: Optional[torch.Tensor],
                 viol: Optional[torch.Tensor], bounds
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        w0, L0, P = self.w0, self.L0, self.plane
        ex = self.mesh.halo_start(p[:w0 * P], p[(L0 - w0) * P:])
        if self.overlap:
            dp = torch.empty_like(p)
            _, ks = self._run(self.geom_int, c, p, a, mask, viol, bounds,
                              w0, dp[w0 * P:(L0 - w0) * P])
            up, dn = ex.wait()
            _, ks_top = self._run(self.geom_top, c,
                                  torch.cat([up, p[:2 * w0 * P]]), a, mask,
                                  viol, bounds, 0, dp[:w0 * P])
            _, ks_bot = self._run(self.geom_bot, c,
                                  torch.cat([p[(L0 - 2 * w0) * P:], dn]), a,
                                  mask, viol, bounds, L0 - w0,
                                  dp[(L0 - w0) * P:])
            ks = ks + ks_top + ks_bot
        else:
            up, dn = ex.wait()
            dp, ks = self._run(self.geom, c, torch.cat([up, p, dn]), a,
                               mask, viol, bounds, 0)
        if ks.numel():
            self.mesh.all_reduce(ks)
        return dp, ks

    def comm_values_per_matvec(self) -> int:
        """Values of ``p`` crossing ranks per matvec, over all ranks: two
        halos of ``w0`` planes at each of the ``size - 1`` slab
        boundaries.  The reference counts the mask's planes too; here
        only ``p`` crosses."""
        return 2 * self.w0 * self.plane * (self.mesh.size - 1)
