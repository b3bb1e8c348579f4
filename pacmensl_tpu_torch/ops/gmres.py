"""Matrix-free restarted GMRES over :class:`~.vecops.FspVector` values.

Counterpart of ``pacmensl_tpu/ops/gmres.py`` (the reference's PETSc SPGMR,
CVODE's linear solver, ``src/OdeSolver/CvodeFsp.cpp:137-200``): Arnoldi
with modified Gram-Schmidt, Givens rotations tracking the residual for an
early exit, a masked back-substitution, restarts, no preconditioner.  The
arithmetic is the reference package's: the same target
``max(tol * |b|, atol)``, the rotation denominator ``sqrt(a^2 + b^2)``,
the residual of the last cycle taken from the rotations, and only Arnoldi
matvecs counted in ``n_matvecs`` (the residual matvec that opens each
cycle is not).

The loop runs on the host; vectors stay on their device.  Host syncs
(each marked ``sync`` below, spans ``HostSync.<site>``): the norm of
``b`` once (``GMRESNorm``), the residual norm once per restart cycle
(``GMRESResidual``), and once per Arnoldi iteration the new Hessenberg
column (``GMRESColumn``: the dots ``h_ij`` stay on the device through the
orthogonalization and come back with the norm in one copy).  The Givens
rotations and the back-substitution run on the host in float64.  Spans:
``GMRES`` around a solve, ``GMRESOrthogonalize`` around one Arnoldi
iteration's Gram-Schmidt and norm (the normalisation needs the synced
norm, so it follows the sync, outside the span).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..sys.events import EVT_GMRES, EVT_ORTHO, span
from . import vecops as vo


class GmresResult(NamedTuple):
    x: vo.FspVector
    res_norm: float
    n_matvecs: int
    converged: bool


def gmres(apply_A: Callable[[vo.FspVector], vo.FspVector],
          b: vo.FspVector,
          x0: vo.FspVector,
          *,
          restart: int = 30,
          tol: float = 1.0e-10,
          atol: float = 1.0e-14,
          max_restarts: int = 40,
          basis: Optional[vo.FspBasis] = None) -> GmresResult:
    """Solve ``A x = b`` for a linear map ``apply_A``.  ``basis`` is
    optional storage for ``restart + 1`` vectors shaped like ``b``."""
    m = int(restart)
    if basis is None or basis.p.shape[0] < m + 1:
        basis = vo.basis_empty(b, m + 1)
    V = basis
    with span(EVT_GMRES), np.errstate(all="ignore"):
        bnorm = np.float64(vo.to_host(vo.norm2(b), "GMRESNorm"))   # sync
        # np.maximum: a NaN norm propagates and ends the solve unconverged
        target = np.maximum(np.float64(tol) * bnorm, np.float64(atol))
        x, rnorm, nmv, it = x0, np.float64(np.inf), 0, 0
        while rnorm > target and it < max_restarts:
            r = vo.sub(b, apply_A(x))
            beta = np.float64(vo.to_host(vo.norm2(r),
                                         "GMRESResidual"))    # sync
            safe_beta = beta if beta > 0 else np.float64(1.0)
            torch.mul(r.p, float(1.0 / safe_beta), out=V.p[0])
            torch.mul(r.sinks, float(1.0 / safe_beta), out=V.sinks[0])
            H = np.zeros((m + 1, m))
            cs = np.zeros(m)
            sn = np.zeros(m)
            g = np.zeros(m + 1)
            g[0] = beta
            j, res = 0, beta
            while j < m and res > target:
                w = apply_A(vo.basis_get(V, j))
                nmv += 1
                with span(EVT_ORTHO):
                    hs_dev = []
                    for i in range(j + 1):
                        vi = vo.basis_get(V, i)
                        h = vo.vdot(w, vi)
                        w.p.addcmul_(vi.p, -h)
                        if w.sinks.numel():
                            w.sinks.addcmul_(vi.sinks, -h)
                        hs_dev.append(h)
                    hs_dev.append(vo.norm2(w))
                    col_dev = torch.stack(hs_dev)
                col = vo.to_host(col_dev, "GMRESColumn")      # sync
                hs = col[j + 1]
                inv = 1.0 / (hs if hs > 0 else np.float64(1.0))
                torch.mul(w.p, float(inv), out=V.p[j + 1])
                torch.mul(w.sinks, float(inv), out=V.sinks[j + 1])
                col = np.concatenate([col, np.zeros(m - 1 - j)])
                # apply the stored rotations to the new column
                for i in range(j):
                    hi = cs[i] * col[i] + sn[i] * col[i + 1]
                    hi1 = -sn[i] * col[i] + cs[i] * col[i + 1]
                    col[i], col[i + 1] = hi, hi1
                # the new rotation zeroing col[j + 1]
                denom = np.sqrt(col[j] ** 2 + col[j + 1] ** 2)
                denom = denom if denom > 0 else np.float64(1.0)
                c_new, s_new = col[j] / denom, col[j + 1] / denom
                col[j] = c_new * col[j] + s_new * col[j + 1]
                col[j + 1] = 0.0
                H[:, j] = col
                cs[j], sn[j] = c_new, s_new
                g_j1 = -s_new * g[j]
                g[j + 1] = g_j1
                g[j] = c_new * g[j]
                res = np.abs(g_j1)
                j += 1
            # masked upper-triangular solve H[:k, :k] y = g[:k]
            k = j
            live = np.arange(m) < k
            Hk = H[:m, :] + np.diag(np.where(live, 0.0, 1.0))
            gk = np.where(live, g[:m], 0.0)
            yk = np.zeros(m)
            for i in range(m - 1, -1, -1):
                yk[i] = (gk[i] - np.dot(Hk[i, :], yk)) / Hk[i, i]
            if k:
                x = vo.add(x, vo.basis_lincomb(torch.from_numpy(yk[:k]), V))
            rnorm, it = res, it + 1
    return GmresResult(x=x, res_norm=float(rnorm), n_matvecs=nmv,
                       converged=bool(rnorm <= target))
