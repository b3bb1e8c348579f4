"""The compressed (ELL) operator over the ranks of a process group.

Counterpart of ``pacmensl_tpu/parallel/halo_ell.py``
(``ShardedEllOperator``), the reference's distributed SpMV (PETSc
``MatMult`` on MPISELL matrices with a ``VecScatter`` halo,
``src/Matrix/FspMatrixBase.cpp:36-62``):

* every rank builds the same state set (its expansion decisions come from
  all-reduced sinks) and the padded state list of ``n_pad`` entries, a
  multiple of the rank count, is cut into contiguous blocks of
  ``L = n_pad / size``: rank r owns rows ``[r L, (r + 1) L)`` (the
  reference's contiguous row partition, ``StateSetBase.h:133-144``) and
  assembles only those;
* at assembly each rank sorts the sources of its rows into local and
  remote ones and lists, for each peer, the sorted global indices it needs
  from it (the VecScatter plan).  The list sizes are exchanged once per
  epoch (one all-gather, which also sums the nonzeros, so every rank's
  cost model sees the same count), and the lists themselves once (one
  all-to-all), so each rank learns what it sends;
* a matvec gathers the requested entries of the local ``p``, runs one
  ``all_to_all_single`` with uneven splits, the plain ELL gather over
  ``cat(p_local, halo)`` (the reference's ``:325-327``; the bucket-shift
  gather stays unported), the local boundary-weight product for the
  sinks, and one ``all_reduce`` of the sinks.  :meth:`action_batched`
  exchanges the halos of all its vectors in the one all-to-all and
  reduces their sinks in the one all-reduce.

With the gloo backend and CUDA tensors both collectives stage through
host memory (``parallel/mesh.py``).  Vectors are the rank's block ``[L]``;
sinks are replicated.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..models.model import Model
from ..ops.ell_operator import EllOperator, _round_up
from ..ops.vecops import FspVector
from ..statespace.state_set import StateSet
from ..sys.events import EVT_ACTION, span
from .mesh import StateMesh

#: the quantum of the padded state list per rank (the reference's 128
#: lanes: ``n_pad`` is a multiple of ``128 * size``, as its is)
LANE_QUANTUM = 128


class ShardedEllOperator(EllOperator):
    """ELL CME operator on this rank's block of the state list, with an
    explicit halo exchange over ``mesh``'s ranks."""

    def __init__(self, model: Model, state_set: StateSet, mesh: StateMesh,
                 dtype=torch.float64,
                 enable_reactions: Optional[Sequence[int]] = None):
        self.mesh = mesh
        self._D = int(mesh.size)
        #: the reference's padded halo width, monotone over the epochs
        self._halo_floor = 0
        super().__init__(model, state_set, dtype=dtype, device=mesh.device,
                         pad_to=LANE_QUANTUM * self._D,
                         enable_reactions=enable_reactions)

    def _row_range(self):
        L = self.n_pad // self._D
        return self.mesh.rank * L, (self.mesh.rank + 1) * L

    def _assemble(self) -> None:
        super()._assemble()
        self._build_plan()

    # --------------------------------------------------------- the plan
    def _build_plan(self) -> None:
        """The exchange plan of this epoch (host and device set-up, never
        in a matvec)."""
        D, r, dev = self._D, self.mesh.rank, self.device
        L = self.n_pad // D
        self.shard_len = L
        src, used = self.src_idx, self.off_val != 0
        owner = src // L
        reqs = [torch.unique(src[used & (owner == o)]) if o != r
                else src.new_zeros(0) for o in range(D)]
        mine = torch.tensor([q.numel() for q in reqs] + [self._nnz],
                            dtype=torch.int64)
        table = (self.mesh.all_gather(mine.to(dev)[None]).cpu()
                 if D > 1 else mine[None])
        #: sizes[d, o]: entries rank d needs from rank o
        self.sizes = table[:, :D]
        self._nnz = int(table[:, D].sum())
        self.halo_width = _round_up(max(int(self.sizes.max()), 1), 8)
        self._halo_floor = max(self._halo_floor, self.halo_width)
        self._recv_splits = self.sizes[r].tolist()
        self._send_splits = self.sizes[:, r].tolist()
        # what each peer asks of this rank, as local indices
        wanted = torch.cat(reqs)
        if D > 1:
            wanted = self.mesh.all_to_all(wanted, self._recv_splits,
                                          self._send_splits)
        self.send_idx = wanted - r * L
        # one gather index into cat(p_local [L], halo): local sources at
        # their local index, remote ones after L at their place in the
        # halo (peers in rank order, each list sorted)
        uni = torch.where(used & (owner == r), src - r * L,
                          torch.zeros_like(src))
        base = L
        for o in range(D):
            if o == r or not reqs[o].numel():
                continue
            m = used & (owner == o)
            uni[m] = base + torch.searchsorted(reqs[o], src[m])
            base += reqs[o].numel()
        self.src_uni = uni

    # ------------------------------------------------------------ action
    def _halos(self, p: torch.Tensor) -> torch.Tensor:
        """``[nb, H]`` halo entries of the vectors ``p [nb, L]``, in one
        all-to-all."""
        if self._D == 1:
            return p.new_zeros((p.shape[0], 0))
        send = p[:, self.send_idx].T                    # [sent, nb]
        return self.mesh.all_to_all(send, self._send_splits,
                                    self._recv_splits).T

    def _local(self, c, p, halo, out=None):
        """dp over the rank's rows and its partial sinks, for one
        vector."""
        ext = torch.cat([p, halo])
        g = ext[self.src_uni]                       # [R, L]
        g.mul_(self.off_val)
        dp = (torch.mv(g.T, c, out=out) if out is not None
              else torch.mv(g.T, c))
        dp.sub_(p * self._out_rate)
        sinks = torch.mv(self.sink_w, c[self.sink_r] * p[self.sink_x])
        return dp, sinks

    def action(self, t, y: FspVector, c=None, out=None) -> FspVector:
        """dy/dt = A(t) y on the rank's block: one all-to-all, one
        all-reduce."""
        with span(EVT_ACTION):
            c = self.coefficients(t, c)
            halo = self._halos(y.p[None])[0]
            dp, sinks = self._local(c, y.p, halo, out)
            if self._D > 1:
                self.mesh.all_reduce(sinks)
            return FspVector(p=dp, sinks=sinks)

    def action_batched(self, t, p: torch.Tensor, c=None, out=None):
        """``(dp [nb, L], sinks [nb, n_c])`` of A(t) on each row of ``p
        [nb, L]``: one all-to-all and one all-reduce for all of them."""
        with span(EVT_ACTION):
            c = self.coefficients(t, c)
            halo = self._halos(p)
            if out is None:
                out = torch.empty_like(p)
            sinks = torch.stack([
                self._local(c, p[i], halo[i], out[i])[1]
                for i in range(p.shape[0])])
            if self._D > 1:
                self.mesh.all_reduce(sinks)
            return out, sinks

    # ------------------------------------------------------------- misc
    @property
    def local_n(self) -> int:
        """Length of an operator vector's ``p``: the rank's block."""
        return self.n_pad // self._D

    def zero_vector(self) -> FspVector:
        return FspVector(
            p=torch.zeros(self.local_n, dtype=self.dtype, device=self.device),
            sinks=torch.zeros(self.num_constraints, dtype=self.dtype,
                              device=self.device))

    def comm_values_per_matvec(self) -> int:
        """The reference's count of values crossing ranks per matvec, its
        padded exchange of ``size * size * halo_width`` entries (with the
        widest halo of any epoch so far)."""
        return self._D * self._D * self._halo_floor

    def values_sent_per_matvec(self) -> int:
        """Entries this port's uneven all-to-all moves per matvec, over
        every rank."""
        return int(self.sizes.sum())
