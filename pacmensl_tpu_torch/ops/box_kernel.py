"""Fused box-action kernel: CUDA loader, wrappers and plain PyTorch versions.

Counterpart of ``pacmensl_tpu/ops/pallas_box.py`` (``PallasBoxKernel``).
The kernel (``csrc/box_action.cu``, see its header for what it computes and
what bounds it) is built and loaded at first use by :mod:`.cuda_build`
(``nvcc`` for ``sm_90a``, a plain C interface, ``ctypes``).  A failed build
or launch raises; there is no fallback.

It has two modes, each with a wrapper that dispatches on the device of
its tensors (CUDA tensors launch the kernel, CPU tensors run the plain
PyTorch version of the same function, which the CPU tests pin to the
reference package and ``chip_smoke.py`` compares the kernel with):

* :func:`box_action` reads the validity mask and the violation bits
  (the TPU kernel's K1/K2); plain version :func:`box_action_reference`;
* :func:`box_action_synth` computes both from the constraint form and the
  epoch's bounds (K3, ``synth_mask=True``); plain version
  :func:`box_action_synth_reference`.

:func:`box_action_batched` and :func:`box_action_synth_batched` launch
either mode on ``nb`` vectors at once (K9, the counterpart of the
reference package's ``vmap`` of the action over the sensitivity vectors);
their plain versions run the single plain versions over the leading axis.
On a window (a geometry built with ``g0``) with each vector's halos
(``[nb, ...]``) they are K9w, the counterpart of the ``vmap`` of the
sharded action, in one launch on the window as K4.

Either mode runs on a window of a box split into axis-0 slabs (K4, the
TPU kernel's sharded mode) when its :class:`BoxGeometry` is built with the
window's global origin, the global axis-0 extent and the rows it owns.

The propensities ``a`` are a :class:`PropTables` (per reaction a table
along the one axis it varies on, or a field row over the window), or an
``[R, n]`` tensor of fields, which the wrappers take as all field rows.
"""
from __future__ import annotations

import ctypes
from functools import partial
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..statespace.box_space import EVAL_CHUNK
from ..statespace.constraints import form_values
from ..sys.events import tally
from .cuda_build import CSRC, NVCC_FLAGS, CudaLibrary, KernelError
from .stencil import coord_grid, shift_nd

SOURCE = CSRC / "box_action.cu"

# Fixed maxima of the kernel's parameter struct (csrc/box_action.cu).
MAX_R, MAX_S, MAX_NC = 32, 8, 32
#: synthesized-mask mode: constraints a form may describe, product terms
#: per constraint
MAX_FORM_NC, MAX_PROD = 16, 2
#: box elements: the kernel decodes indices in 32-bit arithmetic
MAX_ELEMS = 2 ** 31 - 1
_I32 = 2 ** 31
#: the kernel's modes, keys of the launch counters: K1, K3, K4 in either
#: of them, and the batched launch K9 and K9w (on a window) in either of
#: them
MODES = ("mask", "synth", "sharded_mask", "sharded_synth", "batched_mask",
         "batched_synth", "batched_sharded_mask", "batched_sharded_synth")
#: threads of a block, and its warps (one unit of rows of the last axis
#: each)
THREADS, WARPS = 256, 8
#: most rows of the last axis in a unit (``BOX_GROUP``): a warp takes
#: ``min(32 // E, GROUP)`` rows of ``E`` elements at a time, one unit
GROUP = 4
#: most blocks of a launch: the 4 blocks the kernel's 64-register cap
#: keeps resident on each of an H100 SXM's 132 SMs
GRID_BLOCKS = 528
#: sink partial slots (``BOX_SLOTS``): unit ``u`` adds to slot
#: ``u % SLOTS`` and the slots are summed in order, so the sinks are
#: bitwise the same whatever the grid, across modes, launches and cards
SLOTS = 4224
#: table axis codes: a field row, and a constant (a table of one entry)
FIELD_ROW, CONST_AXIS = -1, MAX_S
#: tables up to this many bytes are staged in each block's shared memory;
#: larger ones are read from device memory
TAB_SMEM_MAX = 64 * 1024


class _BoxForm(ctypes.Structure):
    _fields_ = [("w", ctypes.c_int * MAX_S),
                ("pu", ctypes.c_int * MAX_PROD),
                ("pi", ctypes.c_int * MAX_PROD),
                ("pj", ctypes.c_int * MAX_PROD),
                ("gate", ctypes.c_int),
                ("gate_val", ctypes.c_int)]


class _BoxParams(ctypes.Structure):
    _fields_ = [("kflat", ctypes.c_longlong * MAX_R),
                ("shape", ctypes.c_longlong * MAX_S),
                ("stoich", (ctypes.c_int * MAX_S) * MAX_R),
                ("n", ctypes.c_longlong),
                ("R", ctypes.c_int),
                ("S", ctypes.c_int),
                ("nc", ctypes.c_int),
                ("form", _BoxForm * MAX_FORM_NC),
                ("dmul", ctypes.c_ulonglong * MAX_S),
                ("dshift", ctypes.c_int * MAX_S),
                ("origin0", ctypes.c_longlong),
                ("g0", ctypes.c_longlong),
                ("out_lo", ctypes.c_longlong),
                ("out_hi", ctypes.c_longlong),
                ("plane", ctypes.c_longlong),
                ("rstride", ctypes.c_longlong),
                ("vstride", ctypes.c_longlong),
                ("up_rows", ctypes.c_longlong),
                ("mid_rows", ctypes.c_longlong),
                ("tab_axis", ctypes.c_int * MAX_R),
                ("tab_off", ctypes.c_int * MAX_R),
                ("tab_shift", ctypes.c_int * MAX_R),
                ("ntab", ctypes.c_int),
                ("tab_smem", ctypes.c_int),
                ("src_mask", ctypes.c_uint * MAX_R),
                ("tgt_mask", ctypes.c_uint * MAX_R),
                ("ntask", ctypes.c_int),
                ("part_total", ctypes.c_int),
                ("ticket_total", ctypes.c_int),
                ("group", ctypes.c_int),
                ("nb", ctypes.c_int),
                ("p_bstride", ctypes.c_longlong),
                ("dp_bstride", ctypes.c_longlong),
                ("nbv", ctypes.c_int),
                ("up_bstride", ctypes.c_longlong),
                ("dn_bstride", ctypes.c_longlong)]


class _BoxPtrs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "p_up", "p", "p_dn", "mask", "tab", "fields", "viol", "dp", "part",
        "sinks", "ticket", "coef", "bounds")]


class KernelInputs:
    """The kernel's per-call inputs in device memory: the time
    coefficients ``c [R]`` (float64) and the synthesized-mask mode's
    constraint bounds ``[nc]`` (int64), one buffer of ``R + nc`` 8-byte
    words that every launch reads.  A launch captured in a CUDA graph so
    runs at the values the buffer holds when the graph replays.
    :meth:`write` rewrites it with one asynchronous copy from pinned
    memory, ordered on the current stream, only where a value differs
    from the last written."""

    def __init__(self, R: int, nc: int, device):
        self.R = int(R)
        self.buf = torch.zeros(self.R + int(nc), dtype=torch.int64,
                               device=device)
        self._c: Optional[list] = None
        self._bounds = np.zeros(int(nc), dtype=np.int64)
        #: copies made
        self.writes = 0

    def write(self, c: list, bounds: Optional[np.ndarray] = None) -> None:
        """Hold ``c`` (floats) and, where given, ``bounds``."""
        if c == self._c and (bounds is None
                             or np.array_equal(bounds, self._bounds)):
            return
        cuda = self.buf.is_cuda
        if cuda and torch.cuda.is_current_stream_capturing():
            raise KernelError("the box kernel's coefficients or bounds "
                              "changed inside a CUDA graph capture")
        b = self._bounds if bounds is None else np.asarray(bounds,
                                                            np.int64)
        host = torch.empty(self.buf.numel(), dtype=torch.int64,
                           pin_memory=cuda)
        h = host.numpy()
        h[:self.R].view(np.float64)[:] = c
        h[self.R:] = b
        self.buf.copy_(host, non_blocking=True)
        self._c, self._bounds = list(c), b.copy()
        self.writes += 1

    def pointers(self) -> Tuple[int, int]:
        """Device addresses of ``c`` and of the bounds."""
        base = self.buf.data_ptr()
        return base, base + 8 * self.R


def form_fits_kernel(form, stoich) -> bool:
    """Whether the synthesized-mask kernel can take ``form`` (a tuple of
    :class:`~..statespace.constraints.ConstraintForm`) for reactions with
    moves ``stoich [R, S]``: at most ``MAX_FORM_NC`` constraints of at most
    ``MAX_PROD`` products, every species index inside the box, int32
    coefficients and products' changes along a move (``u_k s_j`` and
    ``u_k s_i``), and on every row of the last axis a form linear in the
    last coordinate: no product of the last axis with itself and no gate
    on it (where the box has more than one axis)."""
    stoich = np.atleast_2d(np.asarray(stoich, dtype=np.int64))
    num_species = stoich.shape[1]
    if form is None or len(form) > MAX_FORM_NC or num_species > MAX_S:
        return False
    smax = int(np.abs(stoich).max(initial=0))
    for f in form:
        if len(f.products) > MAX_PROD:
            return False
        ints = [w for _, w in f.weights] + [u for u, _, _ in f.products]
        ints.append(2 * smax * sum(abs(u) for u, _, _ in f.products))
        if f.gate is not None:
            ints.append(f.gate[1])
        if any(not -_I32 <= int(v) < _I32 for v in ints):
            return False
        if any(not 0 <= d < num_species for d in f.species):
            return False
        last = num_species - 1
        if num_species > 1 and (
                any(i == last and j == last for _, i, j in f.products)
                or (f.gate is not None and f.gate[0] == last)):
            return False
    return True


def synth_masks(form, stoich) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Per reaction r, bit masks of the constraints that can break at the
    source ``x - s_r`` and at the target ``x + s_r`` of a point ``x`` where
    every constraint holds (the synthesized-mask kernel tests only these).
    A constraint whose score does not change along ``s_r`` never breaks; a
    linear one without a gate breaks only where it grows.  A monotone one
    (:attr:`~..statespace.constraints.ConstraintForm.monotone`) cannot
    break at a source in the box where ``s_r`` has no negative entry on
    the axes it reads (the source lies below ``x`` there), nor at a target
    where ``s_r`` has no positive entry on them and no product of it has
    both factors lowered."""
    stoich = np.atleast_2d(np.asarray(stoich, dtype=np.int64))
    R, S = stoich.shape
    src, tgt = [0] * R, [0] * R
    for c, f in enumerate(form):
        w = np.zeros(S, dtype=np.int64)
        for d, wd in f.weights:
            w[d] += wd
        axes = sorted(set(f.species))
        for r in range(R):
            s = stoich[r]
            dl = int(w @ s)
            d2 = sum(int(u * s[i] * s[j]) for u, i, j in f.products)
            g = np.zeros(S, dtype=np.int64)
            for u, i, j in f.products:
                g[i] += u * s[j]
                g[j] += u * s[i]
            moved = (dl != 0 or d2 != 0 or bool(g.any())
                     or (f.gate is not None and s[f.gate[0]] != 0))
            lin = not f.products and f.gate is None
            at_src = moved and (not lin or dl < 0)
            at_tgt = moved and (not lin or dl > 0)
            if f.monotone:
                if all(s[d] >= 0 for d in axes):
                    at_src = False
                if all(s[d] <= 0 for d in axes) and not any(
                        s[i] < 0 and s[j] < 0 for _, i, j in f.products):
                    at_tgt = False
            src[r] |= int(at_src) << c
            tgt[r] |= int(at_tgt) << c
    return tuple(src), tuple(tgt)


class PropTables:
    """The propensities a_r over a window of ``shape`` (window row 0 at
    global row ``origin0`` of a box of ``g0`` rows), as the kernel reads
    them: per reaction r, ``axis[r]`` is

    * an axis d, and ``a_r(x) = tables[r][x_d]`` (axis 0 at global
      coordinates, ``g0`` entries; other axes ``shape[d]`` entries);
    * :data:`CONST_AXIS`: a constant, a table of one entry;
    * :data:`FIELD_ROW`: ``fields[row[r]]``, a row over the window.

    The tables are packed into one float64 tensor.  :meth:`dense` rebuilds
    the ``[R, n]`` fields (0 on window rows outside the box), which the
    plain versions compute with."""

    def __init__(self, shape, axis, tables, fields=None, origin0: int = 0,
                 g0: Optional[int] = None):
        self.shape = tuple(int(s) for s in shape)
        self.n = int(np.prod(self.shape))
        self.origin0 = int(origin0)
        self.g0 = int(g0) if g0 is not None else self.shape[0]
        self.axis = tuple(int(a) for a in axis)
        self.fields = fields
        offs, rows, parts, k = [], [], [], 0
        for r, ax in enumerate(self.axis):
            if ax == FIELD_ROW:
                offs.append(len(rows))
                rows.append(r)
            else:
                t = tables[r].reshape(-1)
                want = 1 if ax == CONST_AXIS else (
                    self.g0 if ax == 0 else self.shape[ax])
                if t.numel() != want:
                    raise ValueError(f"reaction {r}: a table of {t.numel()} "
                                     f"entries along axis {ax}, expected "
                                     f"{want}")
                offs.append(k)
                parts.append(t)
                k += want
        self.offset = tuple(offs)
        self.tables = tuple(tables[r] if ax != FIELD_ROW else None
                            for r, ax in enumerate(self.axis))
        dev = fields.device if fields is not None else (
            parts[0].device if parts else torch.device("cpu"))
        self.packed = (torch.cat(parts).to(torch.float64).contiguous()
                       if parts else torch.zeros(0, dtype=torch.float64,
                                                 device=dev))
        self.device = dev
        nf = len(rows)
        if nf and (fields is None or tuple(fields.shape) != (nf, self.n)):
            raise ValueError(f"{nf} field rows need fields of shape "
                             f"({nf}, {self.n})")
        self._dense = None

    @classmethod
    def from_fields(cls, a: torch.Tensor, origin0: int = 0,
                    g0: Optional[int] = None, shape=None) -> "PropTables":
        """Every reaction a field row of ``a [R, n]``."""
        return cls(shape if shape is not None else (a.shape[1],),
                   (FIELD_ROW,) * a.shape[0], [None] * a.shape[0], a,
                   origin0, g0)

    @property
    def num_reactions(self) -> int:
        return len(self.axis)

    @property
    def num_field_rows(self) -> int:
        return sum(ax == FIELD_ROW for ax in self.axis)

    def table_bytes(self) -> int:
        return self.packed.numel() * 8

    def field_bytes(self) -> int:
        return self.num_field_rows * self.n * 8

    def _inbox_rows(self) -> torch.Tensor:
        g = torch.arange(self.shape[0], device=self.device) + self.origin0
        return (g >= 0) & (g < self.g0)

    def field(self, r: int) -> torch.Tensor:
        """a_r over the window, [n] float64 (0 on rows outside the
        box)."""
        ax = self.axis[r]
        if ax == FIELD_ROW:
            return self.fields[self.offset[r]]
        S = len(self.shape)
        t = self.tables[r].reshape(-1).to(torch.float64)
        inb = self._inbox_rows()
        if ax == CONST_AXIS:
            v, view = t, (1,) * S
        elif ax == 0:
            g = torch.arange(self.shape[0], device=self.device) + self.origin0
            v = t[g.clamp(0, self.g0 - 1)]
            view = (-1,) + (1,) * (S - 1)
        else:
            v = t
            view = tuple(-1 if d == ax else 1 for d in range(S))
        full = v.reshape(view).expand(self.shape)
        if not bool(inb.all()):
            full = torch.where(inb.reshape((-1,) + (1,) * (S - 1)), full,
                               torch.zeros((), dtype=torch.float64,
                                           device=self.device))
        return full.reshape(-1).clone()

    def dense(self) -> torch.Tensor:
        """[R, n] fields over the window, kept after the first call."""
        if self._dense is None:
            if self.num_reactions == 0:
                self._dense = torch.zeros((0, self.n), dtype=torch.float64,
                                          device=self.device)
            else:
                self._dense = torch.stack(
                    [self.field(r) for r in range(self.num_reactions)])
        return self._dense

    def window(self, origin0: int, rows: int) -> "PropTables":
        """The same propensities over the window of ``rows`` axis-0 planes
        from global row ``origin0`` (these cover the whole box): the
        tables are shared, field rows are cut (0 outside the box)."""
        if self.origin0 != 0 or self.shape[0] != self.g0:
            raise ValueError("window() needs propensities over the whole "
                             "box")
        shape = (int(rows),) + self.shape[1:]
        fields = None
        if self.num_field_rows:
            out = torch.zeros((self.num_field_rows, int(np.prod(shape))),
                              dtype=torch.float64, device=self.device)
            plane = int(np.prod(self.shape[1:]))
            lo, hi = max(origin0, 0), min(origin0 + rows, self.g0)
            if hi > lo:
                out[:, (lo - origin0) * plane:(hi - origin0) * plane] = \
                    self.fields[:, lo * plane:hi * plane]
            fields = out
        return PropTables(shape, self.axis, list(self.tables), fields,
                          origin0, self.g0)

    def _check_for(self, geom: "BoxGeometry", device) -> None:
        if (self.shape != geom.shape or self.origin0 != geom.origin0
                or self.g0 != geom.g0):
            raise ValueError(f"propensities over the window {self.shape} "
                             f"(origin {self.origin0}, {self.g0} rows) do "
                             f"not fit the geometry's {geom.shape} (origin "
                             f"{geom.origin0}, {geom.g0} rows)")
        if self.num_reactions != geom.num_reactions:
            raise ValueError(f"propensities of {self.num_reactions} "
                             f"reactions, expected {geom.num_reactions}")
        if self.packed.device != device:
            raise ValueError(f"propensity tables are on "
                             f"{self.packed.device}, expected {device}")
        if self.fields is not None:
            _check(self.fields, (self.num_field_rows, geom.n),
                   torch.float64, device, "field rows", rows=True)


def as_props(a, geom: "BoxGeometry") -> PropTables:
    """``a`` as :class:`PropTables` for ``geom``'s window: a PropTables as
    it is, an ``[R, n]`` tensor as all field rows."""
    if isinstance(a, PropTables):
        return a
    _check(a, (geom.num_reactions, geom.n), torch.float64, a.device, "a",
           rows=True)
    return PropTables.from_fields(a, geom.origin0, geom.g0, geom.shape)


class BoxGeometry:
    """Static description of one box action: capacity shape, per-reaction
    moves, the constraint count and, for the synthesized-mask mode, the
    constraint form; with the kernel's flat source offsets
    ``k_r = sum_d s_rd * stride_d``.

    Sharded mode (K4), when ``g0`` is given: ``shape`` is a window of
    axis-0 planes of a box whose axis 0 has extent ``g0``; window row 0 is
    global row ``origin0``, and the action computes ``dp`` and the sinks
    for the window's rows ``out_rows = (lo, hi)``.  ``p`` holds the window
    rows ``halo_rows = (up, mid)``: rows ``[up, up + mid)``; the rows above
    and below come as halos or, where no computed row reads them, not at
    all.  Every source a computed row reads must lie in the window or
    outside the global box; other windows raise ``ValueError``.  Without
    ``g0`` the window is the whole box."""

    def __init__(self, shape: Sequence[int], stoich, num_constraints: int,
                 form=None, origin0: int = 0, g0: Optional[int] = None,
                 out_rows: Optional[Tuple[int, int]] = None,
                 halo_rows: Optional[Tuple[int, int]] = None):
        self.shape = tuple(int(s) for s in shape)
        self.stoich = np.atleast_2d(np.asarray(stoich, dtype=np.int64))
        self.nc = int(num_constraints)
        self.form = tuple(form) if form is not None else None
        if self.form is not None and len(self.form) != self.nc:
            raise ValueError(f"form has {len(self.form)} constraints, "
                             f"expected {self.nc}")
        self.n = int(np.prod(self.shape))
        R, S = self.stoich.shape
        if S != len(self.shape):
            raise ValueError("stoichiometry and shape disagree on species")
        self.sharded = g0 is not None
        self.origin0 = int(origin0)
        self.g0 = int(g0) if g0 is not None else self.shape[0]
        self.out_lo, self.out_hi = (tuple(int(v) for v in out_rows)
                                    if out_rows is not None
                                    else (0, self.shape[0]))
        self.halo_rows = (tuple(int(v) for v in halo_rows)
                          if halo_rows is not None else (0, self.shape[0]))
        self.plane = int(np.prod(self.shape[1:]))
        self.n_out = (self.out_hi - self.out_lo) * self.plane
        self._check_window()
        strides = [int(np.prod(self.shape[d + 1:])) for d in range(S)]
        self.kflat = [int(sum(int(self.stoich[r, d]) * strides[d]
                              for d in range(S))) for r in range(R)]
        # the kernel's rows: the last axis (a unit axis appended to a 1-D
        # box), a unit of ``group`` rows of a plane at a time for a warp
        last = self.shape[-1] if S > 1 else 1
        self.group = max(1, min(32 // last, GROUP, self.plane // last))
        self.units = (self.out_hi - self.out_lo) * -(-(self.plane // last)
                                                    // self.group)
        #: sink partial rows a launch writes
        self.nslots = min(self.units, SLOTS)
        #: blocks of a launch
        self.nblocks = max(1, min(-(-self.nslots // WARPS), GRID_BLOCKS))
        self._params: Optional[_BoxParams] = None
        self._ptrs = _BoxPtrs()
        self._c = None
        self._bounds = None
        self._inputs = {}
        self._props_key = None
        self._props_obj = None
        self._narrow = {}
        self._scratch = {}
        self._synth_plain = None
        self._grids = {}
        self._form_range: Optional[int] = None
        self.masks = (synth_masks(self.form, self.stoich)
                      if self.form is not None
                      and form_fits_kernel(self.form, self.stoich) else None)

    def _check_window(self) -> None:
        lo, hi, o, L = self.out_lo, self.out_hi, self.origin0, self.shape[0]
        up_rows, mid = self.halo_rows
        s0 = self.stoich[:, 0]
        up = int(max(s0.max(initial=0), 0))       # sources above a row
        dn = int(max((-s0).max(initial=0), 0))    # sources below a row
        why = None
        if not 0 <= lo <= hi <= L:
            why = f"output rows [{lo}, {hi}) outside the window's {L} rows"
        elif o + lo < 0 or o + hi > self.g0:
            why = (f"output rows [{o + lo}, {o + hi}) (global) outside the "
                   f"box's {self.g0} rows")
        elif lo < up and o > 0:
            why = (f"output row {lo} reads {up} rows above it, which the "
                   "window does not hold")
        elif hi + dn > L and o + L < self.g0:
            why = (f"output row {hi - 1} reads {dn} rows below it, which "
                   "the window does not hold")
        elif not (0 <= up_rows <= lo and hi <= up_rows + mid <= L):
            why = (f"p's rows [{up_rows}, {up_rows + mid}) do not hold the "
                   f"output rows [{lo}, {hi})")
        if why is not None:
            raise ValueError(f"box kernel window (origin {o}, {L} rows, "
                             f"global extent {self.g0}): {why}")
        #: the window rows [a, b) that the computed rows and their sources
        #: span inside the box (none where no row is computed)
        self.read_spans = (((max(lo - up, -o), min(hi + dn, self.g0 - o)),)
                           if hi > lo else ())
        spans = self.read_spans
        #: whether a computed row reads the rows above / below p's
        self.reads_halo = (bool(spans) and spans[0][0] < up_rows,
                           bool(spans) and spans[-1][1] > up_rows + mid)

    @property
    def num_reactions(self) -> int:
        return self.stoich.shape[0]

    @property
    def p_n(self) -> int:
        """Elements of ``p`` (the window rows it holds)."""
        return self.halo_rows[1] * self.plane

    def halo_n(self) -> Tuple[int, int]:
        """Elements of the halos above and below ``p``."""
        up, mid = self.halo_rows
        return up * self.plane, (self.shape[0] - up - mid) * self.plane

    def mode_key(self, mode: str, batched: bool = False) -> str:
        """The launch counter of ``mode`` ("mask" or "synth") on this
        geometry: K4's own where the geometry is a window; with
        ``batched`` K9's, or K9w's on a window."""
        key = "sharded_" + mode if self.sharded else mode
        return "batched_" + key if batched else key

    def narrow(self, bounds) -> bool:
        """Whether the synthesized-mask kernel may evaluate the form in
        int32: every value it forms at a box point and at its neighbours
        x -/+ s_r (bounded by sum |w| Y + sum |u| Y^2 with
        Y = max extent + 2 max |s|), and every bound, fits.  The int32
        evaluation is then exact, the same as the int64 one."""
        if self._form_range is None:
            Y = (max(max(self.shape), self.g0)
                 + 2 * int(np.abs(self.stoich).max(initial=0)))
            self._form_range = max(
                (sum(abs(w) for _, w in f.weights) * Y
                 + sum(abs(u) for u, _, _ in f.products) * Y * Y
                 for f in self.form), default=0)
        b = np.abs(np.asarray(bounds, dtype=np.int64))
        return self._form_range < _I32 and int(b.max(initial=0)) < _I32

    def _narrow_of(self, bounds: np.ndarray) -> bool:
        key = bounds.tobytes()
        got = self._narrow.get(key)
        if got is None:
            got = self._narrow[key] = bool(self.narrow(bounds))
        return got

    def params(self, c, bounds=None, props: Optional[PropTables] = None
               ) -> _BoxParams:
        """The kernel's parameter struct for the layout of the
        propensities ``props``, built once; each call rewrites only what
        changed.  The coefficients ``c`` and, for the synthesized-mask
        mode, the constraint ``bounds`` are checked and kept for the
        launch, which reads them from device memory
        (:meth:`inputs`)."""
        R, S = self.stoich.shape
        if R > MAX_R or S > MAX_S or self.nc > MAX_NC:
            raise KernelError(
                f"box kernel takes at most {MAX_R} reactions, {MAX_S} "
                f"species and {MAX_NC} constraints (got {R}, {S}, "
                f"{self.nc})")
        if self.n > MAX_ELEMS:
            raise KernelError(f"box kernel takes at most {MAX_ELEMS} "
                              f"elements (got {self.n})")
        if self._params is None:
            self._params = self._build_params()
        prm = self._params
        c = [float(v) for v in (c.tolist() if torch.is_tensor(c) else c)]
        if len(c) != R:
            raise ValueError(f"c has {len(c)} entries, expected {R}")
        self._c = c
        if bounds is not None:
            if self.masks is None:
                raise KernelError(
                    "the synthesized-mask kernel needs a constraint form "
                    f"of at most {MAX_FORM_NC} constraints with at most "
                    f"{MAX_PROD} products each and int32 coefficients")
            b = np.asarray(bounds, dtype=np.int64).reshape(-1)
            if self._bounds is None or not np.array_equal(b, self._bounds):
                self._bounds = b.copy()
        if props is not None and props is not self._props_obj:
            key = (props.axis, props.offset, props.packed.numel(),
                   props.fields.stride(0) if props.num_field_rows else 0)
            if key != self._props_key:
                for r, ax in enumerate(props.axis):
                    prm.tab_axis[r] = ax
                    prm.tab_off[r] = props.offset[r]
                    prm.tab_shift[r] = (int(self.stoich[r, ax])
                                        if 0 <= ax < S else 0)
                prm.ntab = props.packed.numel()
                prm.tab_smem = int(prm.ntab * 8 <= TAB_SMEM_MAX)
                prm.rstride = key[3] if key[3] else self.n
                self._props_key = key
            self._props_obj = props
        return prm

    def _build_params(self) -> _BoxParams:
        R, S = self.stoich.shape
        # a 1-D box runs as (rows, 1): the kernel's rows lie along a last
        # axis of its own
        shape = self.shape if S > 1 else self.shape + (1,)
        prm = _BoxParams()
        for r in range(R):
            prm.kflat[r] = self.kflat[r]
            for d in range(S):
                prm.stoich[r][d] = int(self.stoich[r, d])
        for d, e in enumerate(shape):
            prm.shape[d] = e
            # round-up reciprocal: exact quotients below 2^31
            prm.dshift[d] = 31 + (e - 1).bit_length()
            prm.dmul[d] = -(-(1 << prm.dshift[d]) // e)
        prm.n, prm.R, prm.S, prm.nc = self.n, R, len(shape), self.nc
        prm.origin0, prm.g0 = self.origin0, self.g0
        prm.out_lo, prm.out_hi = self.out_lo, self.out_hi
        prm.up_rows, prm.mid_rows = self.halo_rows
        prm.plane, prm.rstride, prm.vstride = self.plane, self.n, self.n
        prm.part_total, prm.ticket_total = self.nslots, self.nblocks
        prm.group = self.group
        prm.nb, prm.p_bstride, prm.dp_bstride = 1, self.p_n, self.n_out
        prm.up_bstride, prm.dn_bstride = self.halo_n()
        if self.masks is not None:
            for k, f in enumerate(self.form):
                pf = prm.form[k]
                for d, w in f.weights:
                    pf.w[d] += int(w)
                for m, (u, i, j) in enumerate(f.products):
                    pf.pu[m], pf.pi[m], pf.pj[m] = int(u), int(i), int(j)
                pf.gate, pf.gate_val = ((int(f.gate[0]), int(f.gate[1]))
                                        if f.gate is not None else (-1, 0))
            for r in range(R):
                prm.src_mask[r], prm.tgt_mask[r] = (self.masks[0][r],
                                                    self.masks[1][r])
            prm.ntask = sum(bin(m).count("1") for ms in self.masks
                            for m in ms)
        return prm

    def inputs(self, device) -> KernelInputs:
        """This geometry's :class:`KernelInputs` on ``device``."""
        got = self._inputs.get(device)
        if got is None:
            got = self._inputs[device] = KernelInputs(
                self.num_reactions, self.nc, device)
        return got

    def write_inputs(self, device, synth: bool) -> KernelInputs:
        """The coefficients and, with ``synth``, the bounds of the last
        :meth:`params` call in the device buffer on ``device``."""
        inp = self.inputs(device)
        inp.write(self._c, self._bounds if synth else None)
        return inp

    def scratch(self, device, nb: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The sink partials (room for ``nb`` vectors' in a batched
        launch) and the ticket of this geometry's launches on
        ``device``."""
        got = self._scratch.get(device)
        need = max(nb * self.nslots * self.nc, 1)
        if got is None or got[0].numel() < need:
            # launches on one stream run in order, so a larger array may
            # replace the one an earlier launch still reads
            got = self._scratch[device] = (
                torch.empty(need, dtype=torch.float64, device=device),
                got[1] if got is not None
                else torch.zeros(1, dtype=torch.int32, device=device))
        return got


class BoxActionKernel(CudaLibrary):
    """The compiled library, built and loaded at first launch, and the
    counters, one per mode (:data:`MODES`).  ``launches`` counts kernel
    launches (through :func:`~..sys.events.tally`: a launch captured in a
    CUDA graph counts at each replay); ``plain_cuda_calls`` counts calls of the plain versions on
    CUDA tensors (the solve path makes none); ``plain_calls`` counts calls
    of the plain versions on any device.  ``flags``: nvcc's (the
    production build's by default)."""

    def __init__(self, flags=NVCC_FLAGS):
        super().__init__(SOURCE, flags)
        self.reset_counts()

    def reset_counts(self) -> None:
        self.launches = dict.fromkeys(MODES, 0)
        self.plain_cuda_calls = dict.fromkeys(MODES, 0)
        self.plain_calls = dict.fromkeys(MODES, 0)

    def bind(self, lib) -> None:
        for name in ("box_action_params_size", "box_action_ptrs_size",
                     "box_action_threads", "box_action_max_form_constraints"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        lib.box_action_launch.argtypes = (
            [ctypes.POINTER(_BoxParams), ctypes.POINTER(_BoxPtrs)]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.box_action_launch.restype = ctypes.c_int
        lib.box_action_grid.argtypes = (
            [ctypes.POINTER(_BoxParams)] + [ctypes.c_int] * 4
            + [ctypes.POINTER(ctypes.c_int)])
        lib.box_action_grid.restype = ctypes.c_int
        if lib.box_action_max_form_constraints() != MAX_FORM_NC:
            raise KernelError("MAX_FORM_NC differs between the kernel and "
                              "its wrapper")
        if lib.box_action_threads() != THREADS:
            raise KernelError("THREADS differs between the kernel and its "
                              "wrapper")
        for name, struct in (("params", _BoxParams), ("ptrs", _BoxPtrs)):
            size = getattr(lib, f"box_action_{name}_size")()
            if size != ctypes.sizeof(struct):
                raise KernelError(f"{name} struct size mismatch: kernel "
                                  f"{size} B, wrapper "
                                  f"{ctypes.sizeof(struct)} B")

    # ----------------------------------------------------------- launch
    def launch(self, mode: str, c, p, a, geom: BoxGeometry, mask=None,
               viol=None, bounds=None, out=None, halos=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One launch of ``mode`` ("mask": K1/K2, "synth": K3; K4 on a
        window; K9 where ``p`` is ``[nb, n]``, K9w on a window, with
        halos ``[nb, ...]``).  Returns ``(dp, sinks)`` (``[nb, n]`` and
        ``[nb, n_c]`` for K9).  ``out`` may be a row range of a wider
        ``[nb, m]`` tensor (its rows contiguous)."""
        lib = self.lib if self.lib is not None else self.load()
        dev = p.device
        R, n = geom.num_reactions, geom.n
        batched = p.dim() == 2
        nb = p.shape[0] if batched else 1
        if batched:
            if not 1 <= nb <= 65535:
                raise ValueError(f"a batch of {nb} vectors; the batched "
                                 "launch takes 1 to 65535")
            _check(p, (nb, geom.p_n), torch.float64, dev, "p")
        else:
            _check(p, (geom.p_n,), torch.float64, dev, "p")
        props = as_props(a, geom)
        if props is not geom._props_obj:
            props._check_for(geom, dev)
        synth = mode == "synth"
        if synth:
            bounds = np.asarray(bounds, dtype=np.int64).reshape(-1)
            if bounds.shape != (geom.nc,):
                raise ValueError(f"bounds has shape {bounds.shape}, "
                                 f"expected ({geom.nc},)")
            prm = geom.params(c, bounds, props)
        else:
            _check(mask, (n,), torch.uint8, dev, "mask")
            _check(viol, (R, n), torch.int32, dev, "viol", rows=True)
            prm = geom.params(c, None, props)
            prm.vstride = viol.stride(0) if R > 1 else n
        # vectors of the launch; a batched launch picks its chunks of
        # vectors and its grid itself
        prm.nb = nb
        narrow = int(synth and geom._narrow_of(bounds))
        if batched:
            if out is None:
                dp = torch.empty((nb, geom.n_out), dtype=torch.float64,
                                 device=dev)
            else:
                _check(out, (nb, geom.n_out), torch.float64, dev, "out",
                       rows=True)
                dp = out
            prm.p_bstride, prm.dp_bstride = p.stride(0), dp.stride(0)
            prm.ticket_total = _batched_ticket(lib, prm, geom, nb, synth,
                                               narrow, dev)
            sinks = torch.empty((nb, geom.nc), dtype=torch.float64,
                                device=dev)
        elif out is None:
            # dp and the sinks in one allocation
            buf = torch.empty(geom.n_out + geom.nc, dtype=torch.float64,
                              device=dev)
            dp, sinks = buf[:geom.n_out], buf[geom.n_out:]
        else:
            _check(out, (geom.n_out,), torch.float64, dev, "out")
            dp = out
            sinks = torch.empty(geom.nc, dtype=torch.float64, device=dev)
        if not batched:
            prm.ticket_total = geom.nblocks
        part, ticket = geom.scratch(dev, nb)
        up, dn = halos if halos is not None else (None, None)
        q = geom._ptrs
        lead = (nb,) if batched else ()
        q.p_up = _halo_ptr(up, lead + (geom.halo_n()[0],),
                           geom.reads_halo[0], dev, "the halo above")
        q.p_dn = _halo_ptr(dn, lead + (geom.halo_n()[1],),
                           geom.reads_halo[1], dev, "the halo below")
        q.p = p.data_ptr()
        q.mask = mask.data_ptr() if mask is not None else None
        q.tab = props.packed.data_ptr() if props.packed.numel() else None
        q.fields = (props.fields.data_ptr() if props.num_field_rows
                    else None)
        q.viol = viol.data_ptr() if viol is not None else None
        q.dp = dp.data_ptr()
        q.part, q.ticket = part.data_ptr(), ticket.data_ptr()
        q.sinks = sinks.data_ptr()
        q.coef, q.bounds = geom.write_inputs(dev, synth).pointers()
        rc = lib.box_action_launch(
            ctypes.byref(prm), ctypes.byref(q), geom.nblocks, int(synth),
            narrow, dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
        if rc != 0:
            raise KernelError(f"box_action launch ({mode}"
                              f"{', batched' if batched else ''}) failed: "
                              f"cudaError {rc}")
        tally(partial(self._count_launch, geom.mode_key(mode, batched)))
        return dp, sinks

    def _count_launch(self, key: str) -> None:
        self.launches[key] += 1


def _batched_ticket(lib, prm, geom: BoxGeometry, nb: int, synth: bool,
                    narrow: int, dev) -> int:
    """The blocks a batched launch's ticket counts, its grid's, from
    the kernel's own rule (``box_action_grid``), kept per geometry and
    layout."""
    key = (nb, synth, narrow, prm.ntab, prm.tab_smem, dev.index)
    got = geom._grids.get(key)
    if got is None:
        prm.ticket_total = geom.nblocks
        grid = (ctypes.c_int * 4)()
        rc = lib.box_action_grid(ctypes.byref(prm), geom.nblocks,
                                 int(synth), narrow, dev.index, grid)
        if rc != 0:
            raise KernelError(f"box_action grid failed: cudaError {rc}")
        got = geom._grids[key] = grid[0] * grid[1]
    return got


def _halo_ptr(t, shape, read: bool, device, name: str):
    """The device pointer of a halo of ``shape`` (``(n,)``, or ``(nb,
    n)`` in a batched launch), or None where it is absent; absent only
    where no computed row reads it."""
    if t is None:
        if read and shape[-1]:
            raise ValueError(f"{name} is read and was not given")
        return None
    _check(t, shape, torch.float64, device, name)
    return t.data_ptr()


def _check(t: torch.Tensor, shape, dtype, device, name: str,
           rows: bool = False) -> None:
    """Device, type, shape and layout of a kernel argument: contiguous, or
    with ``rows`` a [R, n] tensor whose rows are contiguous (a column
    range of a wider field)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    ok = (t.stride(-1) == 1 and t.stride(0) >= shape[-1]
          if rows and t.dim() == 2 and shape[0] > 1 else t.is_contiguous())
    if not ok:
        raise ValueError(f"{name} must be contiguous"
                         + (" along its rows" if rows else ""))


#: the process-wide compiled library and its launch counters
KERNEL = BoxActionKernel()


def pack_bits(over: torch.Tensor) -> torch.Tensor:
    """[m, n_c] bool -> [m] int32 words, bit c = over[:, c] (bit 31 set is
    a negative int32, which the kernel reads back as unsigned)."""
    nc = over.shape[1]
    weights = torch.tensor([1 << c for c in range(nc)], dtype=torch.int64,
                           device=over.device)
    bits = (over.to(torch.int64) * weights[None, :]).sum(dim=1)
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)


def form_mask_and_bits(geom: BoxGeometry, bounds, device
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the synthesized-mask kernel computes in registers, as the
    mask-reading kernel's inputs: the mask [n] uint8 (every constraint of
    the form holds at x) and the violation bits [R, n] int32 (bit c =
    f_c(x + s_r) > b_c), from ``geom.form`` at ``bounds``, at the
    window's global coordinates."""
    b = torch.tensor(np.asarray(bounds, dtype=np.int64), device=device)
    mask = torch.empty(geom.n, dtype=torch.uint8, device=device)
    viol = torch.empty((geom.num_reactions, geom.n), dtype=torch.int32,
                       device=device)
    for lo in range(0, geom.n, EVAL_CHUNK):
        hi = min(geom.n, lo + EVAL_CHUNK)
        x = coord_grid(geom.shape, device, lo, hi, geom.origin0)
        mask[lo:hi] = (form_values(geom.form, x) <= b[None, :]).all(
            dim=1).to(torch.uint8)
        for r in range(geom.num_reactions):
            s = torch.as_tensor(geom.stoich[r], device=device)
            viol[r, lo:hi] = pack_bits(
                form_values(geom.form, x + s[None, :]) > b[None, :])
    return mask, viol


def _window_p(p, geom: BoxGeometry, halos) -> torch.Tensor:
    """p over the whole window: the halos (zeros where absent) around
    ``p``."""
    n_up, n_dn = geom.halo_n()
    if not n_up and not n_dn:
        return p
    up, dn = halos if halos is not None else (None, None)
    zero = torch.zeros(0, dtype=p.dtype, device=p.device)
    parts = [up if up is not None else zero.new_zeros(n_up), p,
             dn if dn is not None else zero.new_zeros(n_dn)]
    return torch.cat(parts)


def _masked_stencil(c, p, mask, a, viol, geom: BoxGeometry, out=None,
                    halos=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-filled box shifts (``shift_nd``) and dense masked sink sums,
    in the kernel's order of accumulation over reactions, over the whole
    window; ``dp`` and the sinks of its computed rows.  Rows outside the
    global box count as invalid, as the kernel's axis-0 source test makes
    them."""
    c = [float(v) for v in (c.tolist() if torch.is_tensor(c) else c)]
    shape = geom.shape
    a = as_props(a, geom).dense()
    mb = mask.reshape(shape) != 0
    if geom.sharded:
        g = torch.arange(shape[0], device=p.device) + geom.origin0
        inbox = ((g >= 0) & (g < geom.g0)).reshape((-1,) + (1,) * (
            len(shape) - 1))
        mb = mb & inbox
    pb = _window_p(p, geom, halos).reshape(shape)
    rows = slice(geom.out_lo, geom.out_hi)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    dp = torch.zeros_like(pb)
    sinks = [zero] * geom.nc
    for r in range(geom.num_reactions):
        ap = torch.where(mb, a[r].reshape(shape) * pb, zero)
        inflow = torch.where(mb, shift_nd(ap, geom.stoich[r]), zero)
        dp = dp + c[r] * (inflow - ap)
        bits = viol[r].reshape(shape)[rows]
        for cc in range(geom.nc):
            sel = ((bits >> cc) & 1) != 0
            sinks[cc] = sinks[cc] + c[r] * torch.where(sel, ap[rows],
                                                       zero).sum()
    sk = (torch.stack(sinks) if geom.nc
          else torch.zeros(0, dtype=p.dtype, device=p.device))
    dp = dp[rows]
    if out is None:
        return dp.reshape(-1), sk
    out.view(dp.shape).copy_(dp)
    return out, sk


def _count_plain(geom: BoxGeometry, mode: str, p) -> None:
    key = geom.mode_key(mode)
    KERNEL.plain_calls[key] += 1
    if p.is_cuda:
        KERNEL.plain_cuda_calls[key] += 1


def box_action_reference(c, p, mask, a, viol, geom: BoxGeometry, out=None,
                         halos=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the mask-reading kernel."""
    _count_plain(geom, "mask", p)
    return _masked_stencil(c, p, mask, a, viol, geom, out, halos)


def box_action_synth_reference(c, p, a, bounds, geom: BoxGeometry,
                               out=None, halos=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the synthesized-mask kernel: the mask and
    the violation bits from the form's torch evaluator, then the same
    masked stencil and sink sums."""
    _count_plain(geom, "synth", p)
    mask, viol = _synth_data(geom, bounds, p.device)
    return _masked_stencil(c, p, mask, a, viol, geom, out, halos)


def _synth_data(geom: BoxGeometry, bounds, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`form_mask_and_bits` of the last bounds, kept on the
    geometry: a solve calls the plain versions many times per epoch with
    the same bounds."""
    key = (np.asarray(bounds, dtype=np.int64).tobytes(), device)
    if geom._synth_plain is None or geom._synth_plain[0] != key:
        geom._synth_plain = None
        geom._synth_plain = (key,) + form_mask_and_bits(geom, bounds,
                                                         device)
    return geom._synth_plain[1:]


def box_action(c, p, mask, a, viol, geom: BoxGeometry, out=None, halos=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dp, sinks)`` of the truncated generator applied to ``p``.

    ``c [R]`` time coefficients (host floats or a CPU tensor), ``p``
    float64 over the window rows ``geom.halo_rows`` names (the whole box by
    default), ``halos = (up, dn)`` the rows above and below it (either may
    be None where no computed row reads it), ``mask [n]`` uint8, ``a`` the
    propensities (:class:`PropTables`, or ``[R, n]`` float64 fields),
    ``viol [R, n]`` int32 violation bits (``a`` and ``viol`` may be column
    ranges of wider fields).  ``dp`` has ``geom.n_out`` elements, written
    into ``out`` where given.  CUDA tensors launch the kernel; CPU tensors
    run :func:`box_action_reference`."""
    if p.device.type == "cuda":
        return KERNEL.launch("mask", c, p, a, geom, mask=mask, viol=viol,
                             out=out, halos=halos)
    if p.device.type == "cpu":
        return box_action_reference(c, p, mask, a, viol, geom, out, halos)
    raise ValueError(f"unsupported device {p.device}")


def box_action_synth(c, p, a, bounds, geom: BoxGeometry, out=None,
                     halos=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`box_action` with the mask and the violation bits computed
    from ``geom.form`` at the constraint ``bounds [n_c]`` (host integers).
    Equal to :func:`box_action` wherever the mask is exactly "every
    constraint holds".  CUDA tensors launch the kernel; CPU tensors run
    :func:`box_action_synth_reference`."""
    if p.device.type == "cuda":
        return KERNEL.launch("synth", c, p, a, geom, bounds=bounds, out=out,
                             halos=halos)
    if p.device.type == "cpu":
        return box_action_synth_reference(c, p, a, bounds, geom, out, halos)
    raise ValueError(f"unsupported device {p.device}")


def _batched_plain(mode: str, geom: BoxGeometry, p, out, halos, one
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A plain version over the leading axis of ``p [nb, n]``: ``one(row,
    out_row, halos_row)`` for each vector, stacked."""
    if p.dim() != 2:
        raise ValueError(f"p has shape {tuple(p.shape)}, expected [nb, n]")
    key = geom.mode_key(mode, batched=True)
    KERNEL.plain_calls[key] += 1
    if p.is_cuda:
        KERNEL.plain_cuda_calls[key] += 1
    dps, sks = [], []
    for b in range(p.shape[0]):
        hb = (None if halos is None else
              tuple(None if h is None else h[b] for h in halos))
        dp, sk = one(p[b], None if out is None else out[b], hb)
        dps.append(dp)
        sks.append(sk)
    return ((out if out is not None else torch.stack(dps)),
            torch.stack(sks))


def box_action_batched_reference(c, p, mask, a, viol, geom: BoxGeometry,
                                 out=None, halos=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the batched mask-reading launch (K9, K9w
    on a window): the mask-reading plain version over the leading axis of
    ``p`` and of each halo."""
    return _batched_plain("mask", geom, p, out, halos,
                          lambda pb, ob, hb: _masked_stencil(
                              c, pb, mask, a, viol, geom, ob, hb))


def box_action_synth_batched_reference(c, p, a, bounds, geom: BoxGeometry,
                                       out=None, halos=None
                                       ) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Plain PyTorch version of the batched synthesized-mask launch (K9,
    K9w on a window): the synthesized-mask plain version over the leading
    axis of ``p`` and of each halo."""
    mask, viol = _synth_data(geom, bounds, p.device)
    return _batched_plain("synth", geom, p, out, halos,
                          lambda pb, ob, hb: _masked_stencil(
                              c, pb, mask, a, viol, geom, ob, hb))


def box_action_batched(c, p, mask, a, viol, geom: BoxGeometry, out=None,
                       halos=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`box_action` on each of the ``nb`` vectors ``p [nb, n]`` in
    one launch (K9; the reference package ``vmap``s the action over the
    sensitivity vectors): ``dp [nb, n]`` (written into ``out`` where
    given) and ``sinks [nb, n_c]``, bitwise ``nb`` single launches'.  On
    a window (K9w) ``halos = (up [nb, ...], dn [nb, ...])``, either None
    where no computed row reads it.  CUDA tensors launch the kernel; CPU
    tensors run :func:`box_action_batched_reference`."""
    if p.device.type == "cuda":
        return KERNEL.launch("mask", c, p, a, geom, mask=mask, viol=viol,
                             out=out, halos=halos)
    if p.device.type == "cpu":
        return box_action_batched_reference(c, p, mask, a, viol, geom, out,
                                            halos)
    raise ValueError(f"unsupported device {p.device}")


def box_action_synth_batched(c, p, a, bounds, geom: BoxGeometry, out=None,
                             halos=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`box_action_synth` on each of the ``nb`` vectors ``p [nb,
    n]`` in one launch (K9, K9w on a window), as
    :func:`box_action_batched`.  CUDA tensors launch the kernel; CPU
    tensors run :func:`box_action_synth_batched_reference`."""
    if p.device.type == "cuda":
        return KERNEL.launch("synth", c, p, a, geom, bounds=bounds, out=out,
                             halos=halos)
    if p.device.type == "cpu":
        return box_action_synth_batched_reference(c, p, a, bounds, geom,
                                                  out, halos)
    raise ValueError(f"unsupported device {p.device}")
