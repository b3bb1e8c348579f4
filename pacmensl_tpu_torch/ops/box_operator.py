"""Matrix-free dense-box CME operator.

Counterpart of ``pacmensl_tpu/ops/box_operator.py`` (the reference operator
stack ``FspMatrixBase`` + ``FspMatrixConstrained``, ``src/Matrix/*.cpp``).
The action

    (A(t) p)_x = sum_r c_r(t) [ a_r(x - s_r) p(x - s_r) - a_r(x) p(x) ]

plus the sink derivatives (a transition leaving the constraint set adds
to the sink of every constraint its target violates) is one call of the
box kernel (``box_kernel.py``): the CUDA kernel for CUDA tensors, its
plain PyTorch version for CPU tensors.  The kernel has two modes, chosen
as the reference package chooses them (``box_operator.py:189-198``):

* synthesized mask (:func:`~.box_kernel.box_action_synth`) when the
  space's mask is exactly "every constraint holds"
  (``mask_is_constraint_only``) and the constraints have a form the
  kernel evaluates (and the mask the form gives over the box is the
  space's, checked at selection and every epoch; a mismatch raises);
  :meth:`refresh_data` downgrades to the mask-reading
  mode for good when a later epoch's mask stops being constraint-only
  (reference ``:379-386``);
* mask-reading (:func:`~.box_kernel.box_action`) otherwise.

Operator data, by lifetime:

* per box capacity (construction): the propensity fields ``a [R, n]``,
  evaluated once by the model's torch propensity;
* per expansion epoch (:meth:`refresh_data`): the constraint bounds; in
  the mask-reading mode also the validity mask as uint8 and the
  violation bits ``viol [R, n]`` (bit c = f_c(x + s_r) > b_c);
* per call: the time coefficients c(t), passed by value to the kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.model import Model
from ..statespace.box_space import BoxStateSpace, EVAL_CHUNK, constraint_ok
from ..statespace.constraints import ConstraintSet
from ..sys.errors import StateSpaceError
from .box_kernel import (BoxGeometry, MAX_NC, box_action, box_action_synth,
                         form_fits_kernel, pack_bits)
from .stencil import coord_grid
from .vecops import FspVector

#: choose the synthesized-mask kernel where it applies; False keeps every
#: operator on the mask-reading kernel
USE_SYNTH_MASK = True


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
    viol = torch.empty((R, n), dtype=torch.int32, device=device)
    for lo in range(0, n, EVAL_CHUNK):
        hi = min(n, lo + EVAL_CHUNK)
        x = coord_grid(shape, device, lo, hi)
        for r in range(R):
            s = torch.as_tensor(stoich[r], device=device)
            viol[r, lo:hi] = pack_bits(
                constraints.values(x + s[None, :]) > b[None, :])
    return viol


class BoxOpData(NamedTuple):
    """Per-epoch operator data; ``mask`` and ``viol`` are None in the
    synthesized-mask mode, which computes both in the kernel."""
    mask: Optional[torch.Tensor]   # [n] uint8 validity mask
    viol: Optional[torch.Tensor]   # [R, n] int32 violation bits
    bounds: np.ndarray             # [n_c] constraint bounds of this epoch


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
        form = space.constraints.form
        if not form_fits_kernel(form, model.stoichiometry):
            form = None
        self.geom = BoxGeometry(self.shape, model.stoichiometry,
                                space.num_constraints, form)
        self.prop_fields = propensity_fields(model, self.shape,
                                             self.device, dtype)
        #: the kernel mode: True = synthesized mask, False = mask-reading
        self.synth_mask = self._synth_applies()
        self._data = None
        self.refresh_data()

    def _synth_applies(self) -> bool:
        if not (USE_SYNTH_MASK and self.geom.form is not None
                and bool(self.space.mask_is_constraint_only)):
            return False
        # The form was checked against the constraint function on seeded
        # points only; the kernel trusts it over the whole box, so the
        # mask it synthesizes must be the space's (one pass per epoch).
        synth = constraint_ok(self.space.constraints, self.shape,
                              self.device, by_form=True)
        if not torch.equal(synth, self.space.mask.reshape(-1)):
            raise StateSpaceError(
                "the constraint form disagrees with the constraint function "
                f"at {int((synth != self.space.mask.reshape(-1)).sum())} "
                f"points of the box {self.shape} at bounds "
                f"{self.space.constraints.bounds.tolist()}")
        return True

    # ------------------------------------------------------------- data
    def refresh_data(self) -> BoxOpData:
        """Snapshot the space's current bounds, and in the mask-reading
        mode its mask and violation bits.  Call after every
        ``space.set_bounds`` within capacity (the driver does)."""
        bounds = np.asarray(self.space.constraints.bounds).copy()
        if self.synth_mask and not self._synth_applies():
            # reachability started pruning states: the mask the kernel
            # would synthesize is no longer the space's
            self.synth_mask = False
        if self.synth_mask:
            self._data = BoxOpData(mask=None, viol=None, bounds=bounds)
            return self._data
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
        if d.mask is None:
            dp, dsinks = box_action_synth(c, y.p, self.prop_fields,
                                          d.bounds, self.geom)
        else:
            dp, dsinks = box_action(c, y.p, d.mask, self.prop_fields,
                                    d.viol, self.geom)
        return FspVector(p=dp, sinks=dsinks)

    def diagonal(self, t=0.0) -> torch.Tensor:
        """diag(A(t)) = -sum_r c_r(t) a_r(x), masked (flat [n])."""
        c = self.model.coefficients(t, self.dtype).tolist()
        m = self.space.mask.reshape(-1)
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
