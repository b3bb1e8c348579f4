"""Dense matrix exponential for the small Krylov Hessenberg matrices.

Counterpart of ``pacmensl_tpu/ops/expm.py``: the same Taylor
scaling-and-squaring, so the Krylov integrator's step sequence matches the
reference package's (``torch.linalg.matrix_exp`` uses another
approximation and would move the error estimates by rounding):

    s  = max(0, ceil(log2(||A||_inf)) + 1)
    E  = sum_{k<=18} (A/2^s)^k / k!           (||A/2^s|| <= 0.5)
    E  = E^(2^s)

The order-18 Taylor remainder at scaled norm 0.5 is below 1.6e-23.  The
integrator calls this on the host (CPU tensors).
"""
from __future__ import annotations

import math

import torch

_TAYLOR_ORDER = 18
_MAX_SQUARINGS = 64


def expm(A: torch.Tensor) -> torch.Tensor:
    """exp(A) for a small square matrix."""
    n = A.shape[0]
    norm = float(A.abs().sum(dim=1).max())
    if norm <= 0.5 or not math.isfinite(norm):
        s = 0
    else:
        s = max(0, int(math.ceil(math.log2(max(norm, 1e-300)))) + 1)
        s = min(s, _MAX_SQUARINGS)
    As = A / (2.0 ** s)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    acc, term = eye, eye
    for k in range(1, _TAYLOR_ORDER + 1):
        term = (term @ As) / k
        acc = acc + term
    for _ in range(s):
        acc = acc @ acc
    return acc
