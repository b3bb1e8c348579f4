"""The CME operator over an explicit state list (compressed ELL backend).

Counterpart of ``pacmensl_tpu/ops/ell_operator.py`` (the reference's stored
sparse operator, ``FspMatrixBase::GenerateValues``,
``src/Matrix/FspMatrixBase.cpp:76-251``, kept as PETSc MATMPISELL): every
row (state) has at most one off-diagonal entry per reaction, so the
operator is an ELL layout of ``R`` dense ``[n_pad]`` rows, and the action

    (A(t) p)_i = sum_r c_r(t) [ off_val[r, i] p[src_idx[r, i]]
                                - diag_val[r, i] p[i] ]

is one gather, a product and one matrix-vector product in plain PyTorch
on the vectors' device (the outflow ``sum_r c_r diag_val[r]`` is formed
once per coefficient vector).  The reference package computes it in
XLA, outside any Pallas kernel; the port keeps only its plain gather
(``:325-327``), not the bucket-shift gather that dodges the TPU's slow
element gather.

Sinks: a transition from state i by reaction r that leaves the constraint
set adds ``c_r a_r(x_i) p_i`` to the sink of every constraint its target
violates (the reference's sink rows, FspMatrixConstrained.cpp:173-195).
Only boundary transitions carry sink flow, so assembly compacts them into
M (state, reaction) pairs with a ``[n_c, M]`` weight ``a_r(x_i)`` times the
violated bits; an action gathers ``p`` at the M states and makes one
matrix-vector product.  Temporaries per action: ``[R, n_pad]`` for the
gather, ``[M]`` (M <= R n) for the sinks.

Assembly runs every expansion epoch (``reassemble``): the directory lookups
of the source states on the host, the propensities and constraint checks
on the operator's device with the model's torch functions.  Capacities
follow a 1.5x ladder (``pad_to`` quanta) so vectors and integrator storage
keep their shapes across most epochs; entries past ``n_states`` are zero.

Spans (:func:`~..sys.events.span`): ``OperatorAction`` per action (a
batched one counts once), ``ModelCoefficients`` per c(t) the model
computes.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..models.model import Model
from ..statespace.state_set import StateSet
from ..sys.events import EVT_ACTION, EVT_COEFFS, span
from .vecops import FspVector


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _capacity_ladder(n: int, quantum: int) -> int:
    """Padded capacity: the next rung of a 1.5x geometric ladder in
    multiples of ``quantum`` (the reference package's)."""
    c = quantum
    while c < n:
        c = _round_up(int(c * 3 / 2), quantum)
    return c


class EllOperator:
    """Truncated CME generator over a :class:`StateSet`.

    ``enable_reactions`` restricts it to a subset of the model's reactions
    (the sensitivity operators' derivative terms): their columns, their
    outflow, their sinks and their time coefficients only."""

    def __init__(self, model: Model, state_set: StateSet,
                 dtype=torch.float64, device="cuda", pad_to: int = 128,
                 enable_reactions: Optional[Sequence[int]] = None):
        self.model = model
        self.state_set = state_set
        self.dtype = dtype
        self.device = resolve_device(device)
        self.enable_reactions = tuple(
            int(r) for r in (range(model.num_reactions)
                             if enable_reactions is None
                             else enable_reactions))
        self._rows = list(self.enable_reactions)
        self._pad_quantum = int(pad_to)
        self.n_states = state_set.num_states
        self.n_pad = _capacity_ladder(self.n_states, self._pad_quantum)
        self._assemble()

    def reassemble(self) -> bool:
        """Rebuild the operator arrays after the state set changed (an
        expansion epoch); True when the padded capacity grew, so vectors
        and integrator storage must grow with it."""
        self.n_states = self.state_set.num_states
        grew = self.n_states > self.n_pad
        if grew:
            self.n_pad = _capacity_ladder(self.n_states, self._pad_quantum)
        self._assemble()
        return grew

    def _row_range(self):
        """The rows ``[lo, hi)`` of the padded state list this operator
        assembles: all of them on one device."""
        return 0, self.n_pad

    def _assemble(self) -> None:
        """The arrays of the rows :meth:`_row_range` names, ``[R, hi -
        lo]``; ``src_idx`` holds global indices, ``sink_x`` indices from
        ``lo``."""
        ss, dev, dt = self.state_set, self.device, self.dtype
        lo, hi = self._row_range()
        states = ss.states[lo:max(min(hi, self.n_states), lo)]
        n, width = states.shape[0], hi - lo
        R = len(self.enable_reactions)
        stoich = self.model.stoichiometry
        bounds = ss.constraints.bounds_tensor(dev)
        x = torch.as_tensor(states, device=dev)
        xf = x.to(dt)
        self.src_idx = torch.zeros((R, width), dtype=torch.int64, device=dev)
        self.off_val = torch.zeros((R, width), dtype=dt, device=dev)
        self.diag_val = torch.zeros((R, width), dtype=dt, device=dev)
        sink_x = [torch.zeros(0, dtype=torch.int64, device=dev)]
        sink_r = list(sink_x)
        sink_w = [torch.zeros((ss.num_constraints, 0), dtype=dt, device=dev)]
        for k, r in enumerate(self.enable_reactions if n else ()):
            s = torch.as_tensor(stoich[r], device=dev)
            # inflow to row x from its source x - s_r (the reference's
            # column construction, FspMatrixBase.cpp:132-145)
            idx = torch.as_tensor(ss.state2index(states - stoich[r][None, :]),
                                  device=dev)
            ok = idx >= 0
            self.src_idx[k, :n] = torch.where(ok, idx, 0)
            a_src = torch.as_tensor(self.model.propensity(xf - s.to(dt), r)
                                    ).to(dt).reshape(-1)
            self.off_val[k, :n] = torch.where(ok, a_src, 0.0)
            a = torch.as_tensor(self.model.propensity(xf, r)).to(dt
                                                                 ).reshape(-1)
            self.diag_val[k, :n] = a
            # the constraints the target x + s_r violates
            viol = ss.constraints.values(x + s[None, :]) > bounds[None, :]
            out = torch.nonzero(viol.any(dim=1) & (a != 0)).squeeze(1)
            sink_x.append(out)
            sink_r.append(torch.full_like(out, k))
            sink_w.append(viol[out].T.to(dt) * a[out][None, :])
        self.sink_x = torch.cat(sink_x)
        self.sink_r = torch.cat(sink_r)
        self.sink_w = torch.cat(sink_w, dim=1).contiguous()   # [n_c, M]
        self._nnz = int((self.off_val != 0).sum()) + n
        self._c_host = None         # the outflow is re-formed at next use

    # ------------------------------------------------------------ action
    def coefficients(self, t, c=None) -> torch.Tensor:
        """The enabled reactions' time coefficients at ``t`` on the
        device, from the model's full host coefficient vector ``c`` where
        the caller already holds it (the last one is kept on the device)."""
        if c is None:
            with span(EVT_COEFFS):
                c = self.model.coefficients(t, self.dtype)
        c = c.cpu()[self._rows]
        if self._c_host is None or not torch.equal(c, self._c_host):
            self._c_host = c
            self._c_dev = c.to(self.device)
            # the outflow sum_r c_r a_r(x) at these coefficients
            self._out_rate = torch.mv(self.diag_val.T, self._c_dev)
        return self._c_dev

    def action(self, t, y: FspVector, c=None, out=None) -> FspVector:
        """dy/dt = A(t) y on ``y``'s ``[n_pad]`` vector; ``out``: where to
        write ``dp``.  One ``OperatorAction`` span."""
        with span(EVT_ACTION):
            return self._action(t, y, c, out)

    def _action(self, t, y: FspVector, c=None, out=None) -> FspVector:
        c = self.coefficients(t, c)
        p = y.p
        g = p[self.src_idx]                  # [R, n_pad]
        g.mul_(self.off_val)
        dp = torch.mv(g.T, c, out=out) if out is not None else torch.mv(
            g.T, c)
        dp.sub_(p * self._out_rate)
        sinks = torch.mv(self.sink_w, c[self.sink_r] * p[self.sink_x])
        return FspVector(p=dp, sinks=sinks)

    def action_batched(self, t, p: torch.Tensor, c=None, out=None):
        """``(dp [nb, n_pad], sinks [nb, n_c])`` of A(t) applied to each
        row of ``p [nb, n_pad]``: one ``OperatorAction`` span."""
        nb = p.shape[0]
        with span(EVT_ACTION):
            if out is None:
                out = torch.empty_like(p)
            sinks = []
            for i in range(nb):
                sinks.append(self._action(t, FspVector(p=p[i], sinks=None),
                                          c=c, out=out[i]).sinks)
            return out, torch.stack(sinks)

    def diagonal(self, t=0.0) -> torch.Tensor:
        """diag(A(t)) = -sum_r c_r(t) a_r(x) over the padded vector."""
        self.coefficients(t)
        return -self._out_rate

    # ------------------------------------------------------------- misc
    @property
    def num_constraints(self) -> int:
        return self.state_set.num_constraints

    @property
    def local_n(self) -> int:
        """Length of an operator vector's ``p``."""
        return self.n_pad

    def zero_vector(self) -> FspVector:
        return FspVector(
            p=torch.zeros(self.n_pad, dtype=self.dtype, device=self.device),
            sinks=torch.zeros(self.num_constraints, dtype=self.dtype,
                              device=self.device))

    def local_mv_flops(self) -> float:
        """Reference GetLocalMVFlops analogue (2 flops per nonzero)."""
        return 2.0 * self._nnz

    def nnz(self) -> int:
        return self._nnz

    def dense_matrix(self, t: float = 0.0) -> np.ndarray:
        """The full operator with the sink rows last (tests only)."""
        n, n_c = self.n_states, self.num_constraints
        c = self.coefficients(t).cpu().numpy()
        off = self.off_val.cpu().numpy()
        dia = self.diag_val.cpu().numpy()
        src = self.src_idx.cpu().numpy()
        A = np.zeros((n + n_c, n))
        rows = np.arange(n)
        for k in range(len(self.enable_reactions)):
            np.add.at(A, (rows, src[k, :n]), c[k] * off[k, :n])
            A[rows, rows] -= c[k] * dia[k, :n]
        sx = self.sink_x.cpu().numpy()
        sr = self.sink_r.cpu().numpy()
        w = self.sink_w.cpu().numpy()
        for cc in range(n_c):
            np.add.at(A[n + cc], sx, c[sr] * w[cc])
        return A
