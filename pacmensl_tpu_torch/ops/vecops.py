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
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class FspVector(NamedTuple):
    """(probability vector, sink masses)."""
    p: torch.Tensor       # [n] flat C-order box vector
    sinks: torch.Tensor   # [n_constraints]


def vdot(a: FspVector, b: FspVector) -> torch.Tensor:
    """Inner product over both parts (a 0-d device tensor)."""
    return torch.dot(a.p, b.p) + torch.dot(a.sinks, b.sinks)


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


def zeros_like(x: FspVector) -> FspVector:
    return FspVector(p=torch.zeros_like(x.p), sinks=torch.zeros_like(x.sinks))


def isfinite(x: FspVector) -> torch.Tensor:
    """Every entry of both parts finite (a 0-d bool device tensor)."""
    return torch.isfinite(x.p).all() & torch.isfinite(x.sinks).all()


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
