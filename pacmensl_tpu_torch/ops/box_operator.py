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

With a ``mesh`` (:mod:`..parallel.mesh`) the box is split into axis-0
slabs over its ranks, every rank holding the whole state space: the
operator's fields, mask and violation bits cover the rank's window of
``L0 + 2 w0`` planes at global coordinates, vectors cover its slab, and
:meth:`action` runs :class:`~..parallel.halo_box.ShardedBoxAction` (the
kernel's sharded mode K4 behind a halo exchange).  The mode is chosen
from the replicated space, so every rank chooses the same.  A box the
sharded mode cannot take (axis 0 not divisible by the rank count, slabs
thinner than the halo) raises :class:`SetupError`: there is no other
sharded path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.model import Model
from ..statespace.box_space import BoxStateSpace, EVAL_CHUNK, constraint_ok
from ..statespace.constraints import ConstraintSet
from ..sys.errors import StateSpaceError
from ..parallel.halo_box import ShardedBoxAction, window_rows
from .box_kernel import (BoxGeometry, MAX_NC, box_action, box_action_synth,
                         form_fits_kernel, pack_bits)
from .stencil import coord_grid
from .vecops import FspVector

#: choose the synthesized-mask kernel where it applies; False keeps every
#: operator on the mask-reading kernel
USE_SYNTH_MASK = True


def _in_box(shape, origin0: int, g0) -> range:
    """Flat indices of a window of ``shape`` (row 0 at global row
    ``origin0``) whose rows lie in a box of ``g0`` axis-0 rows (all rows
    where ``g0`` is None)."""
    plane = int(np.prod(shape[1:]))
    if g0 is None:
        return range(0, shape[0] * plane)
    lo = min(max(-origin0, 0), shape[0])
    hi = max(min(g0 - origin0, shape[0]), lo)
    return range(lo * plane, hi * plane)


def propensity_fields(model: Model, shape, device, dtype=torch.float64,
                      origin0: int = 0, g0=None) -> torch.Tensor:
    """a_r over the box (unmasked), [R, n]: coordinates are handed to the
    propensity as float64, as in the reference package.  For a window of
    a box of ``g0`` rows, at global coordinates, and 0 on rows outside
    the box."""
    n = int(np.prod(shape))
    R = model.num_reactions
    a = torch.zeros((R, n), dtype=dtype, device=device)
    span = _in_box(shape, origin0, g0)
    for lo in range(span.start, span.stop, EVAL_CHUNK):
        hi = min(span.stop, lo + EVAL_CHUNK)
        x = coord_grid(shape, device, lo, hi, origin0).to(dtype)
        for r in range(R):
            a[r, lo:hi] = torch.as_tensor(model.propensity(x, r)).to(dtype)
    return a


def violation_bits(constraints: ConstraintSet, stoichiometry, shape,
                   device, origin0: int = 0, g0=None) -> torch.Tensor:
    """[R, n] int32: bit c set where x + s_r violates constraint c of
    ``constraints`` at its bounds (reference sink-row sparsity,
    FspMatrixConstrained.cpp:173-195).  For a window as in
    :func:`propensity_fields`, 0 on rows outside the box."""
    n = int(np.prod(shape))
    stoich = np.atleast_2d(np.asarray(stoichiometry, dtype=np.int64))
    R = stoich.shape[0]
    b = constraints.bounds_tensor(device)
    viol = torch.zeros((R, n), dtype=torch.int32, device=device)
    span = _in_box(shape, origin0, g0)
    for lo in range(span.start, span.stop, EVAL_CHUNK):
        hi = min(span.stop, lo + EVAL_CHUNK)
        x = coord_grid(shape, device, lo, hi, origin0)
        for r in range(R):
            s = torch.as_tensor(stoich[r], device=device)
            viol[r, lo:hi] = pack_bits(
                constraints.values(x + s[None, :]) > b[None, :])
    return viol


class BoxOpData(NamedTuple):
    """Per-epoch operator data (over the rank's window with a mesh);
    ``mask`` and ``viol`` are None in the synthesized-mask mode, which
    computes both in the kernel."""
    mask: Optional[torch.Tensor]   # [n] uint8 validity mask
    viol: Optional[torch.Tensor]   # [R, n] int32 violation bits
    bounds: np.ndarray             # [n_c] constraint bounds of this epoch


class BoxOperator:
    """Truncated CME generator on a :class:`BoxStateSpace`."""

    def __init__(self, model: Model, space: BoxStateSpace,
                 dtype=torch.float64, mesh=None):
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
        #: the sharded action over ``mesh``'s ranks, or None
        self.sharded = None
        self._window = (self.shape, 0, None)   # shape, origin0, g0
        self.local_n = self._n
        if mesh is not None:
            if torch.device(mesh.device) != torch.device(self.device):
                raise ValueError(f"the mesh's device {mesh.device} is not "
                                 f"the space's {self.device}")
            self.sharded = ShardedBoxAction(
                self.shape, model.stoichiometry, space.num_constraints,
                form, mesh)
            sh = self.sharded
            self._window = (sh.window_shape, sh.origin0, self.shape[0])
            self.local_n = sh.L0 * sh.plane
        self.prop_fields = propensity_fields(
            model, self._window[0], self.device, dtype,
            origin0=self._window[1], g0=self._window[2])
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
        shape, origin0, g0 = self._window
        mask = self.space.mask
        if self.sharded is not None:
            mask = window_rows(mask, origin0, shape[0])
        mask = mask.reshape(-1).to(torch.uint8)
        viol = violation_bits(self.space.constraints,
                              self.model.stoichiometry, shape, self.device,
                              origin0=origin0, g0=g0)
        self._data = BoxOpData(mask=mask, viol=viol, bounds=bounds)
        return self._data

    def data(self) -> BoxOpData:
        return self._data

    # ------------------------------------------------------------ action
    def action(self, t, y: FspVector) -> FspVector:
        """dy/dt = A(t) y (the rank's slab of it with a mesh).  On a CUDA
        vector this launches the kernel; on a CPU vector it runs the
        kernel's plain version."""
        d = self._data
        c = self.model.coefficients(t, self.dtype)
        if self.sharded is not None:
            dp, dsinks = self.sharded(c, y.p, self.prop_fields, d.mask,
                                      d.viol, d.bounds)
        elif d.mask is None:
            dp, dsinks = box_action_synth(c, y.p, self.prop_fields,
                                          d.bounds, self.geom)
        else:
            dp, dsinks = box_action(c, y.p, d.mask, self.prop_fields,
                                    d.viol, self.geom)
        return FspVector(p=dp, sinks=dsinks)

    def diagonal(self, t=0.0) -> torch.Tensor:
        """diag(A(t)) = -sum_r c_r(t) a_r(x), masked (flat [n], the rank's
        slab with a mesh)."""
        c = self.model.coefficients(t, self.dtype).tolist()
        m = self.space.mask.reshape(-1)
        a = self.prop_fields
        if self.sharded is not None:
            sh = self.sharded
            own = slice((sh.origin0 + sh.w0) * sh.plane,
                        (sh.origin0 + sh.w0 + sh.L0) * sh.plane)
            m = m[own]
            a = a[:, sh.w0 * sh.plane:(sh.w0 + sh.L0) * sh.plane]
        out = torch.zeros(self.local_n, dtype=self.dtype, device=self.device)
        for r in range(self.model.num_reactions):
            out = out - c[r] * torch.where(
                m, a[r], torch.zeros((), dtype=self.dtype,
                                     device=self.device))
        return out

    # ------------------------------------------------------------- misc
    @property
    def num_constraints(self) -> int:
        return self.space.num_constraints

    def zero_vector(self) -> FspVector:
        return FspVector(
            p=torch.zeros(self.local_n, dtype=self.dtype, device=self.device),
            sinks=torch.zeros(self.num_constraints, dtype=self.dtype,
                              device=self.device))

    def local_mv_flops(self) -> float:
        """FLOP estimate per matvec (reference GetLocalMVFlops,
        FspMatrixBase.cpp:429-444): 2 flops per nonzero, counted on the
        capacity box (the global one with a mesh).  The Krylov cost model
        consumes it, so it matches the reference package's value
        exactly."""
        R = self.model.num_reactions
        return float(2 * (2 * R + 1) * self._n)

    def nnz(self) -> int:
        """Structural nonzeros of the equivalent sparse operator."""
        return (self.model.num_reactions + 1) * self.space.num_states
