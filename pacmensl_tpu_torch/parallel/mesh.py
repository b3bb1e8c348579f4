"""Splitting the FSP box over the ranks of a process group.

Counterpart of ``pacmensl_tpu/parallel/mesh.py``: the reference's MPI
domain decomposition (a contiguous 1-D row partition of the state space,
``src/StateSet/StateSetBase.h:133-144``, with PETSc VecScatter halos inside
MatMult).  The JAX package shards the box over a device mesh and lets XLA
move the data; here every rank is a process with one device, and the
communication is ``torch.distributed`` calls written out:

* the box is cut into equal axis-0 slabs, rank ``r`` holding rows
  ``[r L0, (r + 1) L0)`` of every box vector (:func:`slab_rows`);
* sinks and every host value are replicated;
* reductions are all-reduces, the halo exchange is a pair of sends and
  receives with each neighbour, and a vector's global box is an
  all-gather.

With the gloo backend and CUDA tensors, each collective stages its data
through host memory: that backend's transport, always used for it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device
from ..ops.vecops import FspVector
from ..sys.environment import init
from ..sys.errors import SetupError

#: Name of the mesh axis along which the FSP state space is sharded.
STATE_AXIS = "states"

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}


class StateMesh:
    """The ranks of a process group as a 1-D mesh over the state axis:
    the group, this rank, the rank count and this rank's device."""

    def __init__(self, group, rank: int, size: int, device: torch.device):
        self.group = group
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)
        self.backend = (dist.get_backend(group) if group is not None
                        or dist.is_initialized() else None)

    def __repr__(self):
        return (f"StateMesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend})")

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place all-reduce of ``t`` over the ranks (``"sum"`` or
        ``"min"``); every rank gets the same bits."""
        if self._staged(t):
            h = t.cpu()
            dist.all_reduce(h, _OPS[op], group=self.group)
            t.copy_(h)
        else:
            dist.all_reduce(t, _OPS[op], group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` (equal shapes) concatenated along dim 0, in
        rank order, on every rank."""
        src = t.cpu() if self._staged(t) else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts).to(t.device)

    def halo_start(self, first: torch.Tensor, last: torch.Tensor,
                   up: Optional[torch.Tensor] = None,
                   dn: Optional[torch.Tensor] = None) -> "HaloExchange":
        """Start the exchange of boundary planes: ``first`` (this slab's
        first planes) goes to rank - 1 and ``last`` (its last planes) to
        rank + 1; :meth:`HaloExchange.wait` returns ``(up, dn)``, the last
        planes of rank - 1 and the first planes of rank + 1, received into
        the buffers ``up`` and ``dn`` where given (a halo at an end of the
        box is left as the buffer holds it: zeros in a new one)."""
        return HaloExchange(self, first, last, up, dn)


class HaloExchange:
    """A halo exchange in flight (:meth:`StateMesh.halo_start`)."""

    def __init__(self, mesh: StateMesh, first, last, up=None, dn=None):
        self.device = first.device
        self.out = (up if up is not None else torch.zeros_like(last),
                    dn if dn is not None else torch.zeros_like(first))
        staged = mesh._staged(first)
        if staged:
            first, last = first.cpu(), last.cpu()
            self.up, self.dn = self.out[0].cpu(), self.out[1].cpu()
        else:
            self.up, self.dn = self.out
        ops = []
        if mesh.rank > 0:
            peer = mesh._peer(mesh.rank - 1)
            ops += [dist.P2POp(dist.isend, first.contiguous(), peer,
                               mesh.group),
                    dist.P2POp(dist.irecv, self.up, peer, mesh.group)]
        if mesh.rank < mesh.size - 1:
            peer = mesh._peer(mesh.rank + 1)
            ops += [dist.P2POp(dist.isend, last.contiguous(), peer,
                               mesh.group),
                    dist.P2POp(dist.irecv, self.dn, peer, mesh.group)]
        self._reqs = dist.batch_isend_irecv(ops) if ops else []
        self._sent = (first, last)    # alive until the sends complete

    def wait(self) -> Tuple[torch.Tensor, torch.Tensor]:
        for q in self._reqs:
            q.wait()
        self._reqs, self._sent = [], None
        for buf, got in zip(self.out, (self.up, self.dn)):
            if got is not buf:
                buf.copy_(got)
        return self.out


def make_mesh(device="cuda", group=None) -> StateMesh:
    """1-D mesh over the state axis: the ranks of ``group`` (default: the
    default group, started by :func:`~..sys.environment.init` if needed).
    On CUDA, rank r uses card ``r % torch.cuda.device_count()``, which
    becomes the current device."""
    if not dist.is_initialized():
        init()
    rank = dist.get_rank(group)
    size = dist.get_world_size(group)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = resolve_device("cuda")
        if torch.device(device).index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(dev)
        if dist.get_backend(group) == "nccl":
            raise SetupError("an NCCL group needs CUDA tensors; use gloo "
                             "for a mesh on the CPU")
    return StateMesh(group, rank, size, dev)


def choose_shard_axis(shape: Tuple[int, ...], n_shards: int) -> Optional[int]:
    """Axis of the box to shard (the reference's rule): axis 0 when it
    divides evenly, the one the sharded box kernel exchanges halos along;
    else the largest divisible axis; None when no axis is worth
    sharding."""
    if not shape:
        return None
    if shape[0] >= n_shards and shape[0] % n_shards == 0:
        return 0
    for axis in np.argsort(shape)[::-1]:
        if shape[axis] >= n_shards and shape[axis] % n_shards == 0:
            return int(axis)
    return None


def box_spec(shape: Tuple[int, ...], n_shards: int) -> Tuple:
    """Per-axis sharding of the box: :data:`STATE_AXIS` on the axis
    :func:`choose_shard_axis` picks, None elsewhere (all None when it
    picks none)."""
    axis = choose_shard_axis(shape, n_shards)
    return tuple(STATE_AXIS if d == axis else None
                 for d in range(len(shape)))


def slab_rows(shape: Tuple[int, ...], mesh: StateMesh) -> Tuple[int, int]:
    """Axis-0 rows ``[lo, hi)`` of this rank's slab of a box of ``shape``;
    raises :class:`SetupError` unless axis 0 divides by the rank count."""
    if shape[0] % mesh.size:
        raise SetupError(f"axis 0 of the box {tuple(shape)} does not divide "
                         f"into {mesh.size} equal slabs")
    L0 = shape[0] // mesh.size
    return mesh.rank * L0, (mesh.rank + 1) * L0


def shard_fsp_vector(y, shape: Tuple[int, ...], mesh: StateMesh):
    """This rank's part of an FspVector whose ``p`` is the flat global
    box of ``shape``: the slab of ``p``, and the replicated sinks."""
    lo, hi = slab_rows(shape, mesh)
    plane = int(np.prod(shape[1:]))
    return FspVector(p=y.p[lo * plane:hi * plane].clone(), sinks=y.sinks)


def gather_global(p_loc: torch.Tensor, mesh: StateMesh) -> torch.Tensor:
    """The flat global box vector from every rank's slab ``p_loc``."""
    return mesh.all_gather(p_loc)
