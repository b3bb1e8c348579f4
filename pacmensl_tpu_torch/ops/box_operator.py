"""Matrix-free dense-box CME operator.

Counterpart of ``pacmensl_tpu/ops/box_operator.py`` (the reference operator
stack ``FspMatrixBase`` + ``FspMatrixConstrained``, ``src/Matrix/*.cpp``).
The action

    (A(t) p)_x = sum_r c_r(t) [ a_r(x - s_r) p(x - s_r) - a_r(x) p(x) ]

plus the sink derivatives (a transition leaving the constraint set adds
to the sink of every constraint its target violates) is one call of
:func:`~.box_kernel.box_action`: the CUDA kernel for CUDA tensors, its
plain PyTorch version for CPU tensors.

Operator data, by lifetime:

* per box capacity (construction): the propensity fields ``a [R, n]``,
  evaluated once by the model's torch propensity;
* per expansion epoch (:meth:`refresh_data`): the validity mask as uint8
  and the violation bits ``viol [R, n]`` (bit c = f_c(x + s_r) > b_c);
* per call: the time coefficients c(t), passed by value to the kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.model import Model
from ..statespace.box_space import BoxStateSpace, EVAL_CHUNK
from ..statespace.constraints import ConstraintSet
from .box_kernel import BoxGeometry, MAX_NC, box_action
from .stencil import coord_grid
from .vecops import FspVector


def propensity_fields(model: Model, shape, device,
                      dtype=torch.float64) -> torch.Tensor:
    """a_r over the box (unmasked), [R, n]: coordinates are handed to the
    propensity as float64, as in the reference package."""
    n = int(np.prod(shape))
    R = model.num_reactions
    a = torch.empty((R, n), dtype=dtype, device=device)
    for lo in range(0, n, EVAL_CHUNK):
        hi = min(n, lo + EVAL_CHUNK)
        x = coord_grid(shape, device, lo, hi).to(dtype)
        for r in range(R):
            a[r, lo:hi] = torch.as_tensor(model.propensity(x, r)).to(dtype)
    return a


def violation_bits(constraints: ConstraintSet, stoichiometry, shape,
                   device) -> torch.Tensor:
    """[R, n] int32: bit c set where x + s_r violates constraint c of
    ``constraints`` at its bounds (reference sink-row sparsity,
    FspMatrixConstrained.cpp:173-195)."""
    n = int(np.prod(shape))
    stoich = np.atleast_2d(np.asarray(stoichiometry, dtype=np.int64))
    R = stoich.shape[0]
    b = constraints.bounds_tensor(device)
    weights = torch.tensor(
        [1 << c for c in range(constraints.num_constraints)],
        dtype=torch.int64, device=device)
    viol = torch.empty((R, n), dtype=torch.int32, device=device)
    for lo in range(0, n, EVAL_CHUNK):
        hi = min(n, lo + EVAL_CHUNK)
        x = coord_grid(shape, device, lo, hi)
        for r in range(R):
            s = torch.as_tensor(stoich[r], device=device)
            over = constraints.values(x + s[None, :]) > b[None, :]
            bits = (over.to(torch.int64) * weights[None, :]).sum(dim=1)
            # bit 31 set = negative int32, which the kernel reads back as
            # unsigned
            viol[r, lo:hi] = torch.where(
                bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)
    return viol


class BoxOpData(NamedTuple):
    """Per-epoch operator data."""
    mask: torch.Tensor      # [n] uint8 validity mask
    viol: torch.Tensor      # [R, n] int32 violation bits
    bounds: np.ndarray      # [n_c] constraint bounds of this epoch


class BoxOperator:
    """Truncated CME generator on a :class:`BoxStateSpace`."""

    def __init__(self, model: Model, space: BoxStateSpace,
                 dtype=torch.float64):
        if dtype != torch.float64:
            raise TypeError("the box operator computes in float64")
        self.model = model
        self.space = space
        self.dtype = dtype
        self.device = space.device
        self.shape = tuple(space.shape)
        self._n = int(np.prod(self.shape))
        if space.num_constraints > MAX_NC:
            raise ValueError(f"at most {MAX_NC} constraints are supported")
        self.geom = BoxGeometry(self.shape, model.stoichiometry,
                                space.num_constraints)
        self.prop_fields = propensity_fields(model, self.shape,
                                             self.device, dtype)
        self._data = None
        self.refresh_data()

    # ------------------------------------------------------------- data
    def refresh_data(self) -> BoxOpData:
        """Snapshot the space's current mask and bounds.  Call after every
        ``space.set_bounds`` within capacity (the driver does)."""
        bounds = np.asarray(self.space.constraints.bounds).copy()
        mask = self.space.mask.reshape(-1).to(torch.uint8)
        viol = violation_bits(self.space.constraints,
                              self.model.stoichiometry, self.shape,
                              self.device)
        self._data = BoxOpData(mask=mask, viol=viol, bounds=bounds)
        return self._data

    def data(self) -> BoxOpData:
        return self._data

    # ------------------------------------------------------------ action
    def action(self, t, y: FspVector) -> FspVector:
        """dy/dt = A(t) y.  On a CUDA vector this launches the kernel; on
        a CPU vector it runs the kernel's plain version."""
        d = self._data
        c = self.model.coefficients(t, self.dtype)
        dp, dsinks = box_action(c, y.p, d.mask, self.prop_fields, d.viol,
                                self.geom)
        return FspVector(p=dp, sinks=dsinks)

    def diagonal(self, t=0.0) -> torch.Tensor:
        """diag(A(t)) = -sum_r c_r(t) a_r(x), masked (flat [n])."""
        c = self.model.coefficients(t, self.dtype).tolist()
        m = self._data.mask != 0
        out = torch.zeros(self._n, dtype=self.dtype, device=self.device)
        for r in range(self.model.num_reactions):
            out = out - c[r] * torch.where(
                m, self.prop_fields[r], torch.zeros((), dtype=self.dtype,
                                                    device=self.device))
        return out

    # ------------------------------------------------------------- misc
    @property
    def num_constraints(self) -> int:
        return self.space.num_constraints

    def zero_vector(self) -> FspVector:
        return FspVector(
            p=torch.zeros(self._n, dtype=self.dtype, device=self.device),
            sinks=torch.zeros(self.num_constraints, dtype=self.dtype,
                              device=self.device))

    def local_mv_flops(self) -> float:
        """FLOP estimate per matvec (reference GetLocalMVFlops,
        FspMatrixBase.cpp:429-444): 2 flops per nonzero, counted on the
        capacity box.  The Krylov cost model consumes it, so it matches
        the reference package's value exactly."""
        R = self.model.num_reactions
        return float(2 * (2 * R + 1) * self._n)

    def nnz(self) -> int:
        """Structural nonzeros of the equivalent sparse operator."""
        return (self.model.num_reactions + 1) * self.space.num_states
