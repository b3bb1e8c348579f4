"""FSP solution vectors and their vector-space operations.

Counterpart of ``pacmensl_tpu/ops/vecops.py``.  The FSP solution is the
pair (probability over states, sink masses); the reference appends the
sinks to the tail of its PETSc Vec (``FspMatrixConstrained.cpp:137``).
Here ``p`` is the flat C-order box vector ``[n]`` and ``sinks`` a small
``[n_constraints]`` tensor on the same device; every operation treats the
pair as one vector.

Krylov and GMRES bases and the BDF difference array are stored as a pair of
stacked tensors ``([m, n], [m, n_c])`` (:class:`FspBasis`), allocated once
per operator capacity and overwritten in place.

Sharded solves (:func:`reductions_over`): ``p`` is the rank's slab and the
sinks are replicated, so :func:`vdot`, :func:`norm2`, :func:`isfinite`,
:func:`sum_ranks` and :func:`numel` all-reduce the ``p`` part over the
ranks and add the sink part once.  Every rank then holds the same bits,
and the integrators, which decide on the host from these values only,
take the same steps on every rank.  The axpys and linear combinations
stay local.

Every blocking read of a device value on the host goes through
:func:`to_host`, which records it as a ``HostSync.<site>`` span.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple

import torch

from ..sys.events import EVT_HOST_SYNC, span

#: the mesh whose ranks the reductions run over (None: one device)
_MESH = None


@contextmanager
def reductions_over(mesh):
    """Within the block, reductions run over ``mesh``'s ranks (a
    :class:`~..parallel.mesh.StateMesh`, or None for one device)."""
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield
    finally:
        _MESH = prev


def sum_ranks(t: torch.Tensor) -> torch.Tensor:
    """A local partial sum of a ``p`` part, summed over the ranks."""
    if _MESH is not None:
        _MESH.all_reduce(t)
    return t


def min_ranks(t: torch.Tensor) -> torch.Tensor:
    """Local flags (1 or 0, float), in place their minimum over the
    ranks."""
    if _MESH is not None:
        _MESH.all_reduce(t, op="min")
    return t


def to_host(x: torch.Tensor, site: str):
    """``x`` on the host, a Python number for a 0-d tensor and a numpy
    array otherwise: a copy that waits for the work queued before it,
    recorded as the span ``HostSync.<site>``."""
    with span(EVT_HOST_SYNC + site):
        return x.item() if x.dim() == 0 else x.cpu().numpy()


class FspVector(NamedTuple):
    """(probability vector, sink masses)."""
    p: torch.Tensor       # [n] flat C-order box vector
    sinks: torch.Tensor   # [n_constraints]


def vdot(a: FspVector, b: FspVector) -> torch.Tensor:
    """Inner product over both parts (a 0-d device tensor).  An empty
    sinks part (the stationary solve's vectors) adds no launch."""
    d = sum_ranks(torch.dot(a.p, b.p))
    return d + torch.dot(a.sinks, b.sinks) if a.sinks.numel() else d


def norm2(a: FspVector) -> torch.Tensor:
    return torch.sqrt(vdot(a, a))


def axpy(alpha, x: FspVector, y: FspVector) -> FspVector:
    """y + alpha*x."""
    return FspVector(p=y.p + alpha * x.p, sinks=y.sinks + alpha * x.sinks)


def scale(alpha, x: FspVector) -> FspVector:
    return FspVector(p=alpha * x.p, sinks=alpha * x.sinks)


def add(x: FspVector, y: FspVector) -> FspVector:
    return FspVector(p=x.p + y.p, sinks=x.sinks + y.sinks)


def sub(x: FspVector, y: FspVector) -> FspVector:
    return FspVector(p=x.p - y.p, sinks=x.sinks - y.sinks)


def plus_zero(x: FspVector) -> FspVector:
    """``x`` with 0 added in place, as adding it to a zero vector gives
    (-0 becomes +0, every other entry stays)."""
    x.p.add_(0.0)
    x.sinks.add_(0.0)
    return x


def zeros_like(x: FspVector) -> FspVector:
    return FspVector(p=torch.zeros_like(x.p), sinks=torch.zeros_like(x.sinks))


def isfinite(x: FspVector) -> torch.Tensor:
    """Every entry of both parts finite (a 0-d bool device tensor)."""
    ok = torch.isfinite(x.p).all()
    if _MESH is not None:
        ok = min_ranks(ok.to(torch.float64)) > 0
    return ok & torch.isfinite(x.sinks).all()


def numel(x: FspVector) -> int:
    """Entries of both parts, ``p`` over every rank."""
    return (x.p.numel() * (_MESH.size if _MESH is not None else 1)
            + x.sinks.numel())


class FspBasis(NamedTuple):
    """Stacked basis vectors: ``p [m, n]`` and ``sinks [m, n_c]``."""
    p: torch.Tensor
    sinks: torch.Tensor


def basis_empty(template: FspVector, m: int) -> FspBasis:
    """Allocate (uninitialised) storage for ``m`` basis vectors."""
    return FspBasis(
        p=torch.empty((m,) + tuple(template.p.shape),
                      dtype=template.p.dtype, device=template.p.device),
        sinks=torch.empty((m,) + tuple(template.sinks.shape),
                          dtype=template.sinks.dtype,
                          device=template.sinks.device))


def stack_zeros(template: FspVector, m: int) -> FspBasis:
    """Allocate ``m`` zero basis vectors shaped like ``template``."""
    return FspBasis(
        p=torch.zeros((m,) + tuple(template.p.shape),
                      dtype=template.p.dtype, device=template.p.device),
        sinks=torch.zeros((m,) + tuple(template.sinks.shape),
                          dtype=template.sinks.dtype,
                          device=template.sinks.device))


def basis_set(basis: FspBasis, i: int, vec: FspVector) -> None:
    """basis[i] = vec (in place)."""
    basis.p[i].copy_(vec.p)
    basis.sinks[i].copy_(vec.sinks)


def basis_get(basis: FspBasis, i: int) -> FspVector:
    """View of basis vector ``i``."""
    return FspVector(p=basis.p[i], sinks=basis.sinks[i])


def basis_lincomb(coeffs: torch.Tensor, basis: FspBasis) -> FspVector:
    """sum_i coeffs[i] * basis[i] over the first ``len(coeffs)`` vectors
    (the VecMAXPY of the reference, KrylovFsp.cpp:244-252)."""
    k = coeffs.shape[0]
    c = coeffs.to(device=basis.p.device, dtype=basis.p.dtype)
    return FspVector(p=c @ basis.p[:k], sinks=c @ basis.sinks[:k])
