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

* per box capacity (construction): the propensities
  (:func:`propensity_tables`): for each reaction a table along the one
  axis its propensity varies on, checked bitwise against the model's
  torch propensity over the whole box, or where that fails (a propensity
  of two or more axes) a field row ``[n]``;
* per expansion epoch (:meth:`refresh_data`): the constraint bounds; in
  the mask-reading mode also the validity mask as uint8 and the
  violation bits ``viol [R, n]`` (bit c = f_c(x + s_r) > b_c);
* per call: the time coefficients c(t), passed by value to the kernel.

With a ``mesh`` (:mod:`..parallel.mesh`) the box is split into axis-0
slabs over its ranks, every rank holding the whole state space: the
operator's field rows, mask and violation bits cover the rank's window of
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
from .box_kernel import (CONST_AXIS, FIELD_ROW, BoxGeometry, MAX_NC,
                         PropTables, box_action, box_action_batched,
                         box_action_synth, box_action_synth_batched,
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
                      origin0: int = 0, g0=None,
                      reactions=None) -> torch.Tensor:
    """a_r over the box (unmasked), [R, n] (the rows of ``reactions``
    only, where given): coordinates are handed to the propensity as
    float64, as in the reference package.  For a window of a box of
    ``g0`` rows, at global coordinates, and 0 on rows outside the box."""
    n = int(np.prod(shape))
    rs = list(range(model.num_reactions) if reactions is None
              else reactions)
    a = torch.zeros((len(rs), n), dtype=dtype, device=device)
    span = _in_box(shape, origin0, g0)
    for lo in range(span.start, span.stop, EVAL_CHUNK):
        hi = min(span.stop, lo + EVAL_CHUNK)
        x = coord_grid(shape, device, lo, hi, origin0).to(dtype)
        for k, r in enumerate(rs):
            a[k, lo:hi] = torch.as_tensor(model.propensity(x, r)).to(dtype)
    return a


def propensity_tables(model: Model, shape, device, dtype=torch.float64,
                      origin0: int = 0, g0=None,
                      reactions=None) -> PropTables:
    """The propensities over the box (a window of a box of ``g0`` rows,
    at global coordinates) as the kernel reads them, entry k for reaction
    ``reactions[k]`` (all reactions by default).  For each reaction,
    1-D slices of ``model.propensity`` through the origin (axis 0 over the
    global rows) find the axes it varies along.  Where that is one axis d
    (or none: a constant, one entry), the slice along d is its table,
    kept only if, chunk by chunk over the box, the field equals
    ``table[x_d]`` bitwise; otherwise (two or more axes, a NaN, any
    mismatch) the reaction keeps a field row ``[n]``, 0 on window rows
    outside the box."""
    shape = tuple(int(s) for s in shape)
    S = len(shape)
    rs = list(range(model.num_reactions) if reactions is None
              else reactions)
    G0 = shape[0] if g0 is None else int(g0)
    ext = (G0,) + shape[1:]
    span = _in_box(shape, origin0, g0)
    axis, tables = [], []
    for r in rs:
        lines = []
        for d in range(S):
            x = torch.zeros((ext[d], S), dtype=dtype, device=device)
            x[:, d] = torch.arange(ext[d], dtype=dtype, device=device)
            lines.append(torch.as_tensor(model.propensity(x, r)).to(dtype)
                         .reshape(-1))
        varying = [d for d in range(S)
                   if not bool((lines[d] == lines[d][:1]).all())]
        ax, tab = FIELD_ROW, None
        if len(varying) <= 1:
            ax = varying[0] if varying else CONST_AXIS
            tab = lines[ax] if varying else lines[0][:1].clone()
            for lo in range(span.start, span.stop, EVAL_CHUNK):
                hi = min(span.stop, lo + EVAL_CHUNK)
                xc = coord_grid(shape, device, lo, hi, origin0)
                got = torch.as_tensor(model.propensity(xc.to(dtype), r)
                                      ).to(dtype).reshape(-1)
                want = (tab[xc[:, ax]] if varying
                        else tab.expand(hi - lo))
                if not torch.equal(got, want):
                    ax, tab = FIELD_ROW, None
                    break
        axis.append(ax)
        tables.append(tab)
    fields = None
    rows = [r for k, r in enumerate(rs) if axis[k] == FIELD_ROW]
    if rows:
        fields = propensity_fields(model, shape, device, dtype, origin0, g0,
                                   reactions=rows)
    return PropTables(shape, axis, tables, fields, origin0, G0)


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
    """Truncated CME generator on a :class:`BoxStateSpace`.

    ``enable_reactions`` restricts it to a subset of the model's reactions
    (reference ``enable_reactions``, ``box_operator.py:95-108``): the
    stoichiometry rows, the propensities, the violation bits, the kernel's
    form check and its time coefficients cover those reactions only, and
    the sinks receive only their flow.  The sensitivity operators
    (:mod:`.sens_operator`) build their derivative operators so."""

    def __init__(self, model: Model, space: BoxStateSpace,
                 dtype=torch.float64, mesh=None, enable_reactions=None,
                 synth_mask=None):
        """``synth_mask``: the kernel mode, where the caller chooses it
        for this operator (another operator's on the same space; True
        takes effect only where the constraints have a form the kernel
        takes); None chooses it here."""
        if dtype != torch.float64:
            raise TypeError("the box operator computes in float64")
        self.model = model
        self.space = space
        self.dtype = dtype
        self.device = space.device
        self.shape = tuple(space.shape)
        self._n = int(np.prod(self.shape))
        self.enable_reactions = tuple(
            int(r) for r in (range(model.num_reactions)
                             if enable_reactions is None
                             else enable_reactions))
        #: rows of the model's coefficient vector this operator applies
        #: (None: all of them, in order)
        self._rows = (None if self.enable_reactions
                      == tuple(range(model.num_reactions))
                      else list(self.enable_reactions))
        #: the stoichiometry of the enabled reactions [R_sub, S]
        self.stoichiometry = np.atleast_2d(
            model.stoichiometry[list(self.enable_reactions)])
        if space.num_constraints > MAX_NC:
            raise ValueError(f"at most {MAX_NC} constraints are supported")
        form = space.constraints.form
        if not form_fits_kernel(form, self.stoichiometry):
            form = None
        self.geom = BoxGeometry(self.shape, self.stoichiometry,
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
                self.shape, self.stoichiometry, space.num_constraints,
                form, mesh)
            sh = self.sharded
            self._window = (sh.window_shape, sh.origin0, self.shape[0])
            self.local_n = sh.L0 * sh.plane
        #: the propensities over the window, as the kernel reads them
        self.props = propensity_tables(
            model, self._window[0], self.device, dtype,
            origin0=self._window[1], g0=self._window[2],
            reactions=self.enable_reactions)
        self._prop_fields = None
        #: the kernel mode: True = synthesized mask, False = mask-reading
        self.synth_mask = (self._synth_applies() if synth_mask is None
                           else bool(synth_mask)
                           and self.geom.masks is not None)
        self._data = None
        # the mode was chosen just now: no second check of the form
        self.refresh_data(synth_mask=self.synth_mask)

    @property
    def prop_fields(self) -> torch.Tensor:
        """The ``[R, n]`` propensity fields over the window, evaluated by
        the model's torch propensity at first use (for comparisons; the
        action reads :attr:`props`)."""
        if self._prop_fields is None:
            shape, origin0, g0 = self._window
            self._prop_fields = propensity_fields(
                self.model, shape, self.device, self.dtype, origin0=origin0,
                g0=g0, reactions=self.enable_reactions)
        return self._prop_fields

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
    def refresh_data(self, synth_mask=None) -> BoxOpData:
        """Snapshot the space's current bounds, and in the mask-reading
        mode its mask and violation bits.  Call after every
        ``space.set_bounds`` within capacity (the driver does).
        ``synth_mask=False`` leaves the synthesized-mask mode where the
        caller has found that it no longer applies (None: checked
        here)."""
        bounds = np.asarray(self.space.constraints.bounds).copy()
        if synth_mask is not None:
            self.synth_mask = self.synth_mask and bool(synth_mask)
        elif self.synth_mask and not self._synth_applies():
            # reachability started pruning states: the mask the kernel
            # would synthesize is no longer the space's
            self.synth_mask = False
        if self.synth_mask:
            self._data = BoxOpData(mask=None, viol=None, bounds=bounds)
            return self._data
        shape, origin0, g0 = self._window
        if self.sharded is not None:
            mask = window_rows(self.space.mask, origin0, shape[0])
            mask = mask.reshape(-1).to(torch.uint8)
        else:
            # one copy per epoch, shared by every operator on the space
            mask = self.space.mask_bytes()
        viol = violation_bits(self.space.constraints, self.stoichiometry,
                              shape, self.device, origin0=origin0, g0=g0)
        self._data = BoxOpData(mask=mask, viol=viol, bounds=bounds)
        return self._data

    def data(self) -> BoxOpData:
        return self._data

    # ------------------------------------------------------------ action
    def coefficients(self, t, c=None) -> torch.Tensor:
        """The enabled reactions' time coefficients at ``t``, from the
        model's full coefficient vector ``c`` where the caller already
        holds it."""
        if c is None:
            c = self.model.coefficients(t, self.dtype)
        return c if self._rows is None else c[self._rows]

    def action(self, t, y: FspVector, c=None, out=None) -> FspVector:
        """dy/dt = A(t) y (the rank's slab of it with a mesh).  ``c``:
        the model's coefficients at ``t`` where the caller holds them;
        ``out``: where to write ``dp``.  On a CUDA vector this launches
        the kernel; on a CPU vector it runs the kernel's plain version."""
        d = self._data
        c = self.coefficients(t, c)
        if self.sharded is not None:
            dp, dsinks = self.sharded(c, y.p, self.props, d.mask, d.viol,
                                      d.bounds)
        elif d.mask is None:
            dp, dsinks = box_action_synth(c, y.p, self.props, d.bounds,
                                          self.geom, out=out)
        else:
            dp, dsinks = box_action(c, y.p, d.mask, self.props, d.viol,
                                    self.geom, out=out)
        return FspVector(p=dp, sinks=dsinks)

    def action_batched(self, t, p: torch.Tensor, c=None, out=None):
        """``(dp [nb, n], sinks [nb, n_c])`` of A(t) applied to each row
        of ``p [nb, n]`` in one launch of the batched kernel (K9) on a
        CUDA tensor, by its plain version on a CPU tensor; one device
        only."""
        if self.sharded is not None:
            raise ValueError("the batched action runs on one device")
        d = self._data
        c = self.coefficients(t, c)
        if d.mask is None:
            return box_action_synth_batched(c, p, self.props, d.bounds,
                                            self.geom, out=out)
        return box_action_batched(c, p, d.mask, self.props, d.viol,
                                  self.geom, out=out)

    def diagonal(self, t=0.0) -> torch.Tensor:
        """diag(A(t)) = -sum_r c_r(t) a_r(x), masked (flat [n], the rank's
        slab with a mesh)."""
        c = self.coefficients(t).tolist()
        m = self.space.mask.reshape(-1)
        cols = slice(0, self._n)
        if self.sharded is not None:
            sh = self.sharded
            own = slice((sh.origin0 + sh.w0) * sh.plane,
                        (sh.origin0 + sh.w0 + sh.L0) * sh.plane)
            m = m[own]
            cols = slice(sh.w0 * sh.plane, (sh.w0 + sh.L0) * sh.plane)
        out = torch.zeros(self.local_n, dtype=self.dtype, device=self.device)
        for r in range(len(self.enable_reactions)):
            out = out - c[r] * torch.where(
                m, self.props.field(r)[cols],
                torch.zeros((), dtype=self.dtype, device=self.device))
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
        R = len(self.enable_reactions)
        return float(2 * (2 * R + 1) * self._n)

    def nnz(self) -> int:
        """Structural nonzeros of the equivalent sparse operator."""
        return (len(self.enable_reactions) + 1) * self.space.num_states
