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

Either mode runs on a window of a box split into axis-0 slabs (K4, the
TPU kernel's sharded mode) when its :class:`BoxGeometry` is built with the
window's global origin, the global axis-0 extent and the rows it owns.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..statespace.box_space import EVAL_CHUNK
from ..statespace.constraints import form_values
from .cuda_build import CSRC, CudaLibrary, KernelError
from .stencil import coord_grid, shift_nd

SOURCE = CSRC / "box_action.cu"

# Fixed maxima of the kernel's parameter struct (csrc/box_action.cu).
MAX_R, MAX_S, MAX_NC = 32, 8, 32
#: synthesized-mask mode: constraints a form may describe, product terms
#: per constraint
MAX_FORM_NC, MAX_PROD = 16, 2
#: box elements: the kernel decodes flat indices in 32-bit arithmetic
MAX_ELEMS = 2 ** 31 - 1
_I32 = 2 ** 31
#: the kernel's modes, keys of the launch counters: K1, K3, and K4 in
#: either of them
MODES = ("mask", "synth", "sharded_mask", "sharded_synth")
#: most blocks of a launch: 8 on each of an H100 SXM's 132 SMs.  A fixed
#: grid gives every card the same sink reduction order, so the sinks are
#: bitwise reproducible across cards as well as across launches.
GRID_BLOCKS = 1056


class _BoxForm(ctypes.Structure):
    _fields_ = [("w", ctypes.c_int * MAX_S),
                ("pu", ctypes.c_int * MAX_PROD),
                ("pi", ctypes.c_int * MAX_PROD),
                ("pj", ctypes.c_int * MAX_PROD),
                ("gate", ctypes.c_int),
                ("gate_val", ctypes.c_int)]


class _BoxParams(ctypes.Structure):
    _fields_ = [("c", ctypes.c_double * MAX_R),
                ("kflat", ctypes.c_longlong * MAX_R),
                ("shape", ctypes.c_longlong * MAX_S),
                ("stoich", (ctypes.c_int * MAX_S) * MAX_R),
                ("n", ctypes.c_longlong),
                ("R", ctypes.c_int),
                ("S", ctypes.c_int),
                ("nc", ctypes.c_int),
                ("bounds", ctypes.c_longlong * MAX_FORM_NC),
                ("form", _BoxForm * MAX_FORM_NC),
                ("dmul", ctypes.c_ulonglong * MAX_S),
                ("dshift", ctypes.c_int * MAX_S),
                ("origin0", ctypes.c_longlong),
                ("g0", ctypes.c_longlong),
                ("out_lo", ctypes.c_longlong),
                ("out_hi", ctypes.c_longlong),
                ("plane", ctypes.c_longlong),
                ("rstride", ctypes.c_longlong)]


def form_fits_kernel(form, stoich) -> bool:
    """Whether the synthesized-mask kernel can take ``form`` (a tuple of
    :class:`~..statespace.constraints.ConstraintForm`) for reactions with
    moves ``stoich [R, S]``: at most ``MAX_FORM_NC`` constraints of at most
    ``MAX_PROD`` products, every species index inside the box, int32
    coefficients, and int32 entries in the kernel's table of each
    product's change along a move (``u_k s_j`` and ``u_k s_i``)."""
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
    return True


class BoxGeometry:
    """Static description of one box action: capacity shape, per-reaction
    moves, the constraint count and, for the synthesized-mask mode, the
    constraint form; with the kernel's flat source offsets
    ``k_r = sum_d s_rd * stride_d``.

    Sharded mode (K4), when ``g0`` is given: ``shape`` is a window of
    axis-0 planes of a box whose axis 0 has extent ``g0``; window row 0 is
    global row ``origin0``, and the action computes ``dp`` and the sinks
    only for the window's rows ``out_rows = (lo, hi)``.  Every source an
    output row reads must lie in the window or outside the global box;
    other windows raise ``ValueError``.  Without ``g0`` the window is the
    whole box."""

    def __init__(self, shape: Sequence[int], stoich, num_constraints: int,
                 form=None, origin0: int = 0, g0: Optional[int] = None,
                 out_rows: Optional[Tuple[int, int]] = None):
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
        self.plane = int(np.prod(self.shape[1:]))
        self.n_out = (self.out_hi - self.out_lo) * self.plane
        self._check_window()
        strides = [int(np.prod(self.shape[d + 1:])) for d in range(S)]
        self.kflat = [int(sum(int(self.stoich[r, d]) * strides[d]
                              for d in range(S))) for r in range(R)]
        self._params: Optional[_BoxParams] = None
        self._synth_plain = None
        self._form_range: Optional[int] = None

    def _check_window(self) -> None:
        lo, hi, o, L = self.out_lo, self.out_hi, self.origin0, self.shape[0]
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
        if why is not None:
            raise ValueError(f"box kernel window (origin {o}, {L} rows, "
                             f"global extent {self.g0}): {why}")

    @property
    def num_reactions(self) -> int:
        return self.stoich.shape[0]

    def mode_key(self, mode: str) -> str:
        """The launch counter of ``mode`` ("mask" or "synth") on this
        geometry: K4's own where the geometry is a window."""
        return "sharded_" + mode if self.sharded else mode

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

    def params(self, c, bounds=None) -> _BoxParams:
        """The kernel's parameter struct with coefficients ``c``, and for
        the synthesized-mask mode the constraint ``bounds``."""
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
            prm = _BoxParams()
            for r in range(R):
                prm.kflat[r] = self.kflat[r]
                for d in range(S):
                    prm.stoich[r][d] = int(self.stoich[r, d])
            for d in range(S):
                prm.shape[d] = self.shape[d]
                # round-up reciprocal: exact quotients below 2^31
                prm.dshift[d] = 31 + (self.shape[d] - 1).bit_length()
                prm.dmul[d] = -(-(1 << prm.dshift[d]) // self.shape[d])
            prm.n, prm.R, prm.S, prm.nc = self.n, R, S, self.nc
            prm.origin0, prm.g0 = self.origin0, self.g0
            prm.out_lo, prm.out_hi = self.out_lo, self.out_hi
            prm.plane, prm.rstride = self.plane, self.n
            if self.form is not None and form_fits_kernel(self.form,
                                                          self.stoich):
                for k, f in enumerate(self.form):
                    pf = prm.form[k]
                    for d, w in f.weights:
                        pf.w[d] += int(w)
                    for m, (u, i, j) in enumerate(f.products):
                        pf.pu[m], pf.pi[m], pf.pj[m] = int(u), int(i), int(j)
                    pf.gate, pf.gate_val = ((int(f.gate[0]), int(f.gate[1]))
                                            if f.gate is not None else (-1, 0))
            self._params = prm
        prm = self._params
        for r, v in enumerate(c):
            prm.c[r] = float(v)
        if bounds is not None:
            if not form_fits_kernel(self.form, self.stoich):
                raise KernelError(
                    "the synthesized-mask kernel needs a constraint form "
                    f"of at most {MAX_FORM_NC} constraints with at most "
                    f"{MAX_PROD} products each and int32 coefficients")
            for k, b in enumerate(np.asarray(bounds).reshape(-1)):
                prm.bounds[k] = int(b)
        return prm


class BoxActionKernel(CudaLibrary):
    """The compiled library, built and loaded at first launch, and the
    launch counters, one per mode (``"mask"``, ``"synth"``).  ``launches``
    counts kernel launches; ``plain_cuda_calls`` counts calls of the plain
    versions on CUDA tensors (the solve path makes none)."""

    def __init__(self):
        super().__init__(SOURCE)
        self.reset_counts()

    def reset_counts(self) -> None:
        self.launches = dict.fromkeys(MODES, 0)
        self.plain_cuda_calls = dict.fromkeys(MODES, 0)

    def bind(self, lib) -> None:
        lib.box_action_params_size.argtypes = []
        lib.box_action_params_size.restype = ctypes.c_int
        lib.box_action_threads.argtypes = []
        lib.box_action_threads.restype = ctypes.c_int
        lib.box_action_launch.argtypes = (
            [ctypes.POINTER(_BoxParams)] + [ctypes.c_void_p] * 7
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.box_action_launch.restype = ctypes.c_int
        lib.box_action_synth_launch.argtypes = (
            [ctypes.POINTER(_BoxParams)] + [ctypes.c_void_p] * 5
            + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.box_action_synth_launch.restype = ctypes.c_int
        lib.box_action_max_form_constraints.argtypes = []
        lib.box_action_max_form_constraints.restype = ctypes.c_int
        if lib.box_action_max_form_constraints() != MAX_FORM_NC:
            raise KernelError("MAX_FORM_NC differs between the kernel and "
                              "its wrapper")
        size = lib.box_action_params_size()
        if size != ctypes.sizeof(_BoxParams):
            raise KernelError(f"parameter struct size mismatch: kernel "
                              f"{size} B, wrapper "
                              f"{ctypes.sizeof(_BoxParams)} B")
        self.threads = lib.box_action_threads()

    # ----------------------------------------------------------- launch
    def _outputs(self, p, a, c, geom: BoxGeometry, out):
        """Checks shared by both modes; (c as floats, nblocks, dp, sink
        partials, sinks)."""
        dev = p.device
        R, n, nc = geom.num_reactions, geom.n, geom.nc
        _check(p, (n,), torch.float64, dev, "p")
        _check(a, (R, n), torch.float64, dev, "a", rows=True)
        c = [float(v) for v in (c.tolist() if torch.is_tensor(c) else c)]
        if len(c) != R:
            raise ValueError(f"c has {len(c)} entries, expected {R}")
        nblocks = max(1, min(-(-geom.n_out // self.threads), GRID_BLOCKS))
        if out is None:
            dp = torch.empty(geom.n_out, dtype=torch.float64, device=dev)
        else:
            _check(out, (geom.n_out,), torch.float64, dev, "out")
            dp = out
        part = torch.empty(nblocks * max(nc, 1), dtype=torch.float64,
                           device=dev)
        sinks = torch.empty(max(nc, 1), dtype=torch.float64, device=dev)
        return c, nblocks, dp, part, sinks

    def launch(self, c, p, mask, a, viol, geom: BoxGeometry, out=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The mask-reading kernel (K1/K2, K4 on a window)."""
        lib = self.load()
        dev = p.device
        R, n = geom.num_reactions, geom.n
        _check(mask, (n,), torch.uint8, dev, "mask")
        _check(viol, (R, n), torch.int32, dev, "viol", rows=True)
        if R > 1 and viol.stride(0) != a.stride(0):
            raise ValueError(f"viol's reaction stride {viol.stride(0)} is "
                             f"not a's {a.stride(0)}")
        c, nblocks, dp, part, sinks = self._outputs(p, a, c, geom, out)
        prm = geom.params(c)
        prm.rstride = a.stride(0) if R > 1 else n
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.box_action_launch(
            ctypes.byref(prm), p.data_ptr(), mask.data_ptr(), a.data_ptr(),
            viol.data_ptr(), dp.data_ptr(), part.data_ptr(),
            sinks.data_ptr(), nblocks, dev.index, stream)
        if rc != 0:
            raise KernelError(f"box_action launch failed: cudaError {rc}")
        self.launches[geom.mode_key("mask")] += 1
        return dp, sinks[:geom.nc]

    def launch_synth(self, c, p, a, bounds, geom: BoxGeometry, out=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The synthesized-mask kernel (K3, K4 on a window)."""
        lib = self.load()
        dev = p.device
        bounds = np.asarray(bounds, dtype=np.int64).reshape(-1)
        if bounds.shape != (geom.nc,):
            raise ValueError(f"bounds has shape {bounds.shape}, expected "
                             f"({geom.nc},)")
        c, nblocks, dp, part, sinks = self._outputs(p, a, c, geom, out)
        prm = geom.params(c, bounds)
        prm.rstride = a.stride(0) if geom.num_reactions > 1 else geom.n
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.box_action_synth_launch(
            ctypes.byref(prm), p.data_ptr(), a.data_ptr(), dp.data_ptr(),
            part.data_ptr(), sinks.data_ptr(), nblocks,
            int(geom.narrow(bounds)), dev.index, stream)
        if rc != 0:
            raise KernelError(f"box_action_synth launch failed: cudaError "
                              f"{rc}")
        self.launches[geom.mode_key("synth")] += 1
        return dp, sinks[:geom.nc]


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
    b = torch.as_tensor(np.asarray(bounds, dtype=np.int64), device=device)
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


def _masked_stencil(c, p, mask, a, viol, geom: BoxGeometry, out=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-filled box shifts (``shift_nd``) and dense masked sink sums,
    in the kernel's order of accumulation over reactions, over the whole
    window; ``dp`` and the sinks of its output rows.  Rows outside the
    global box count as invalid, as the kernel's axis-0 source test makes
    them."""
    c = [float(v) for v in (c.tolist() if torch.is_tensor(c) else c)]
    shape = geom.shape
    mb = mask.reshape(shape) != 0
    if geom.sharded:
        g = torch.arange(shape[0], device=p.device) + geom.origin0
        inbox = ((g >= 0) & (g < geom.g0)).reshape((-1,) + (1,) * (
            len(shape) - 1))
        mb = mb & inbox
    pb = p.reshape(shape)
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
    dp = dp[rows].reshape(-1)
    if out is not None:
        dp = out.copy_(dp)
    return dp, sk


def box_action_reference(c, p, mask, a, viol, geom: BoxGeometry, out=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the mask-reading kernel."""
    if p.is_cuda:
        KERNEL.plain_cuda_calls[geom.mode_key("mask")] += 1
    return _masked_stencil(c, p, mask, a, viol, geom, out)


def box_action_synth_reference(c, p, a, bounds, geom: BoxGeometry, out=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the synthesized-mask kernel: the mask and
    the violation bits from the form's torch evaluator, then the same
    masked stencil and sink sums."""
    if p.is_cuda:
        KERNEL.plain_cuda_calls[geom.mode_key("synth")] += 1
    # the synthesized data of the last bounds, kept on the geometry: a
    # solve calls this many times per epoch with the same bounds
    key = (np.asarray(bounds, dtype=np.int64).tobytes(), p.device)
    if geom._synth_plain is None or geom._synth_plain[0] != key:
        geom._synth_plain = None
        geom._synth_plain = (key,) + form_mask_and_bits(geom, bounds,
                                                         p.device)
    _, mask, viol = geom._synth_plain
    return _masked_stencil(c, p, mask, a, viol, geom, out)


def box_action(c, p, mask, a, viol, geom: BoxGeometry, out=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dp, sinks)`` of the truncated generator applied to ``p``.

    ``c [R]`` time coefficients (host floats or a CPU tensor), ``p [n]``
    float64, ``mask [n]`` uint8, ``a [R, n]`` float64 propensity fields,
    ``viol [R, n]`` int32 violation bits (``a`` and ``viol`` may be column
    ranges of wider fields).  ``dp`` has ``geom.n_out`` elements, written
    into ``out`` where given.  CUDA tensors launch the kernel; CPU tensors
    run :func:`box_action_reference`."""
    if p.device.type == "cuda":
        return KERNEL.launch(c, p, mask, a, viol, geom, out)
    if p.device.type == "cpu":
        return box_action_reference(c, p, mask, a, viol, geom, out)
    raise ValueError(f"unsupported device {p.device}")


def box_action_synth(c, p, a, bounds, geom: BoxGeometry, out=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`box_action` with the mask and the violation bits computed
    from ``geom.form`` at the constraint ``bounds [n_c]`` (host integers).
    Equal to :func:`box_action` wherever the mask is exactly "every
    constraint holds".  CUDA tensors launch the kernel; CPU tensors run
    :func:`box_action_synth_reference`."""
    if p.device.type == "cuda":
        return KERNEL.launch_synth(c, p, a, bounds, geom, out)
    if p.device.type == "cpu":
        return box_action_synth_reference(c, p, a, bounds, geom, out)
    raise ValueError(f"unsupported device {p.device}")
