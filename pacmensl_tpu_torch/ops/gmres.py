"""Matrix-free restarted GMRES over :class:`~.vecops.FspVector` values.

Counterpart of ``pacmensl_tpu/ops/gmres.py`` (the reference's PETSc SPGMR,
CVODE's linear solver, ``src/OdeSolver/CvodeFsp.cpp:137-200``): Arnoldi
with modified Gram-Schmidt, Givens rotations tracking the residual for an
early exit, a masked back-substitution, restarts, no preconditioner.  The
arithmetic is the reference package's: the same target
``max(tol * |b|, atol)``, the rotation denominator ``sqrt(a^2 + b^2)``,
the residual of the last cycle taken from the rotations, and only Arnoldi
matvecs counted in ``n_matvecs`` (the residual matvec that opens each
cycle is not).  ``x0=None`` is the zero vector, as SPGMR's zero guess in
CVODE: the first cycle's residual is then ``b`` itself, so it applies no
map and takes no residual norm (counter ``GMRESZeroGuess``, one such
cycle).  Where ``A 0`` is +0 in every entry, as for BDF's corrector map
``v + s A v`` (``0 + s A 0`` is +0), ``b - A 0`` is ``b`` bit for bit and
the solution is bitwise that of an explicit zero ``x0``.

The loop runs on the host; vectors stay on their device.  Host syncs
(each marked ``sync`` below, spans ``HostSync.<site>``): the norm of
``b`` once (``GMRESNorm``), the residual norm once per restart cycle that
applied the map to its start (``GMRESResidual``), and once per Arnoldi
iteration the new Hessenberg
column (``GMRESColumn``: the dots ``h_ij`` stay on the device through the
orthogonalization and come back with the norm in one copy).  The Givens
rotations and the back-substitution run on the host in float64.  Spans:
``GMRES`` around a solve, ``GMRESOrthogonalize`` around one Arnoldi
iteration's Gram-Schmidt and norm.

An Arnoldi iteration's device work is one function of ``j`` with no host
sync (:func:`_arnoldi_step`): the map of ``V[j]``, Gram-Schmidt and the
norm, the column into a static ``[m + 1]`` buffer, and the normalisation
into ``V[j + 1]`` by the device scalar ``1 / where(h > 0, h, 1)`` (after
the span), which rounds as a division on the host would.  The linear map
is a callable, whose ``A V[j]`` is copied into ``V[j + 1]``, or a map
that can also apply itself into a given output with its step-varying
values held on the device (``apply_into(v, out)``, ``capture_key()``;
BDF's :class:`~.box_operator.ShiftedAction` over a box operator or a box
sensitivity operator, without a mesh), which writes ``A V[j]`` straight
into ``V[j + 1]``.  Either way the iteration orthogonalizes and
normalizes it in place there, so both run their reductions on the same
storage and give the same bits.  For such a map on a CUDA
device :class:`ArnoldiGraphs` captures each iteration ``j`` once as a
CUDA graph, the first time it is reached for a basis storage, and replays
it after (spans ``GMRESCapture``, ``GMRESReplay``); the column is read at
the same sync and the rotations are the same.  A replay counts what the
eager iteration counts: the host-side counts the captured code made
through :func:`~..sys.events.tally` (the box kernel's launches, the
stacked action's ``SensActionStates`` and ``SensActionSinks``) run at
each replay, not at the capture.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..sys.events import (EVT_GMRES, EVT_GMRES_CAPTURE, EVT_GMRES_REPLAY,
                          EVT_GMRES_ZERO_GUESS, EVT_ORTHO, count, deferred,
                          span)
from . import vecops as vo

#: replay the Arnoldi iterations of a capturable map from CUDA graphs on a
#: CUDA device; False runs the same iterations eagerly (for tests)
USE_ARNOLDI_GRAPHS = True


class GmresResult(NamedTuple):
    x: vo.FspVector
    res_norm: float
    n_matvecs: int
    converged: bool


class ArnoldiWork(NamedTuple):
    """An Arnoldi iteration's static buffers: the Hessenberg column
    ``[m + 1]`` and the device scalar 1."""
    col: torch.Tensor
    one: torch.Tensor


def _work(V: vo.FspBasis) -> ArnoldiWork:
    col = torch.zeros(V.p.shape[0], dtype=V.p.dtype, device=V.p.device)
    return ArnoldiWork(col, torch.ones((), dtype=V.p.dtype,
                                       device=V.p.device))


def _orthogonalize(w: vo.FspVector, V: vo.FspBasis, j: int) -> list:
    """Modified Gram-Schmidt of ``w`` against ``V[0..j]``, in place: the
    device scalars h_0j .. h_jj and the norm of the result."""
    hs = []
    for i in range(j + 1):
        vi = vo.basis_get(V, i)
        h = vo.vdot(w, vi)
        w.p.addcmul_(vi.p, -h)
        if w.sinks.numel():
            w.sinks.addcmul_(vi.sinks, -h)
        hs.append(h)
    hs.append(vo.norm2(w))
    return hs


def _mapped(A, V: vo.FspBasis, j: int) -> vo.FspVector:
    """``A V[j]`` in ``V[j + 1]``: a capturable map's written there, a
    callable's copied there."""
    v, w = vo.basis_get(V, j), vo.basis_get(V, j + 1)
    if hasattr(A, "apply_into"):
        A.apply_into(v, w)
    else:
        vo.basis_set(V, j + 1, A(v))
    return w


def _arnoldi_step(A, V: vo.FspBasis, j: int, work: ArnoldiWork) -> None:
    """Iteration ``j``'s device work, with no host sync: ``w = A V[j]``
    orthogonalized against ``V[0..j]``, the column h_0j .. h_jj, |w| into
    ``col[:j + 2]``, and ``V[j + 1] = w / where(|w| > 0, |w|, 1)``."""
    col, one = work
    w = _mapped(A, V, j)
    with span(EVT_ORTHO):
        torch.stack(_orthogonalize(w, V, j), out=col[:j + 2])
    hn = col[j + 1]
    inv = one / torch.where(hn > 0, hn, one)
    torch.mul(w.p, inv, out=V.p[j + 1])
    torch.mul(w.sinks, inv, out=V.sinks[j + 1])


#: the side stream captures run on, one a device: each stream's first
#: cuBLAS call sets up a workspace of its own, kept for the process
_CAPTURE_STREAMS = {}


def _capture_stream(dev) -> "torch.cuda.Stream":
    s = _CAPTURE_STREAMS.get(dev)
    if s is None:
        s = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(device=dev)
        s.wait_stream(torch.cuda.current_stream(dev))
        # ... which a capture does not allow: set it up now
        with torch.cuda.stream(s):
            one = torch.ones(1, dtype=torch.float64, device=dev)
            torch.dot(one, one)
    return s


class ArnoldiGraphs:
    """CUDA graphs of the Arnoldi iterations of the GMRES solves of one
    capturable map over one basis storage, and their static buffers.
    Iteration ``j`` is captured the first time it is reached and replayed
    after; the graphs are dropped where the storage or the map's
    ``capture_key()`` changes.  The graphs share one memory pool, which
    goes with them.  The functions the captured code handed
    :func:`~..sys.events.tally` run at each replay, not at the capture."""

    def __init__(self):
        self._key = None
        self._graphs = {}
        self._pool = None
        self.work: Optional[ArnoldiWork] = None

    def reset(self) -> None:
        self._key, self._graphs, self._pool, self.work = None, {}, None, None

    def bind(self, A, V: vo.FspBasis) -> ArnoldiWork:
        """The buffers for ``A`` over ``V``, dropping stale graphs."""
        key = (V.p.data_ptr(), tuple(V.p.shape), V.sinks.data_ptr(),
               A.capture_key())
        if key != self._key:
            self.reset()
            self.work = _work(V)
            self._key = key
        return self.work

    def run(self, A, V: vo.FspBasis, j: int) -> None:
        """Iteration ``j`` from its graph, captured first where it has
        none (:meth:`bind` first)."""
        got = self._graphs.get(j)
        if got is None:
            got = self._graphs[j] = self._capture(A, V, j)
        graph, tallies = got
        with span(EVT_GMRES_REPLAY):
            graph.replay()
        for fn in tallies:
            fn()

    def _capture(self, A, V: vo.FspBasis, j: int):
        dev = V.p.device
        cur, side = torch.cuda.current_stream(dev), _capture_stream(dev)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        with span(EVT_GMRES_CAPTURE), torch.cuda.stream(side), \
                deferred() as tallies:
            graph.capture_begin(pool=self._pool)
            try:
                _arnoldi_step(A, V, j, self.work)
            finally:
                graph.capture_end()
        cur.wait_stream(side)
        return graph, tallies


def gmres(apply_A: Callable[[vo.FspVector], vo.FspVector],
          b: vo.FspVector,
          x0: Optional[vo.FspVector] = None,
          *,
          restart: int = 30,
          tol: float = 1.0e-10,
          atol: float = 1.0e-14,
          max_restarts: int = 40,
          basis: Optional[vo.FspBasis] = None,
          graphs: Optional[ArnoldiGraphs] = None) -> GmresResult:
    """Solve ``A x = b`` for a linear map ``apply_A`` from ``x0`` (None:
    the zero vector).  ``basis`` is optional storage for ``restart + 1``
    vectors shaped like ``b``;
    ``graphs`` keeps the CUDA graphs of a capturable map's iterations
    over it."""
    m = int(restart)
    if basis is None or basis.p.shape[0] < m + 1:
        basis = vo.basis_empty(b, m + 1)
    V = basis
    capturable = hasattr(apply_A, "apply_into")
    if capturable:
        graphs = graphs if graphs is not None else ArnoldiGraphs()
        work = graphs.bind(apply_A, V)
    else:
        work = _work(V)
    replay = capturable and USE_ARNOLDI_GRAPHS and V.p.is_cuda
    with span(EVT_GMRES), np.errstate(all="ignore"):
        bnorm = np.float64(vo.to_host(vo.norm2(b), "GMRESNorm"))   # sync
        # np.maximum: a NaN norm propagates and ends the solve unconverged
        target = np.maximum(np.float64(tol) * bnorm, np.float64(atol))
        x, rnorm, nmv, it = x0, np.float64(np.inf), 0, 0
        while rnorm > target and it < max_restarts:
            if x is None:           # the zero vector: r = b, |r| = |b|
                count(EVT_GMRES_ZERO_GUESS, 1)
                r, beta = b, bnorm
            else:
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
                nmv += 1
                if replay:
                    graphs.run(apply_A, V, j)
                else:
                    _arnoldi_step(apply_A, V, j, work)
                col = vo.to_host(work.col[:j + 2], "GMRESColumn")  # sync
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
                dx = vo.basis_lincomb(torch.from_numpy(yk[:k]), V)
                # from the zero vector: 0 + dx, which turns -0 into +0
                x = vo.plus_zero(dx) if x is None else vo.add(x, dx)
            rnorm, it = res, it + 1
    if x is None:
        x = vo.zeros_like(b)
    return GmresResult(x=x, res_norm=float(rnorm), n_matvecs=nmv,
                       converged=bool(rnorm <= target))
