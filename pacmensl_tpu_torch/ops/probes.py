"""Bandwidth probes: CUDA loader, wrappers, plain PyTorch versions and the
stream measurement.

Counterparts of the reference package's measurement kernels (see
``csrc/probes.cu`` for what each computes and what bounds it):

* :func:`stream_copy` (K5, ``bench.py:167-179``): ``out = x``, the stream
  probe whose rate :func:`stream_bandwidth` returns, the denominator of
  the box kernel's roofline fraction;
* :func:`scaled_copy` (K6, ``tools/bw_probe.py:53-59``):
  ``out = x * 1.0000001``;
* :func:`window_copy` (K7, ``tools/bw_probe.py:69-78``): the middle
  ``T`` rows of each window ``concat(prev_g, x_g, next_g)`` times ``c``;
* :func:`roll_window` (K8, ``tools/bw_probe.py:91-107``):
  ``out_g[j] = sum_k c * w_g[H L + j - k]`` over the flat window.

``x`` and ``out`` are ``[G T, L]`` (any shape for K5 and K6), ``prev`` and
``next`` ``[G H, L]``: block ``g`` of the output reads block ``g`` of both
halo arrays.  Each wrapper dispatches on the device of ``x``: CUDA tensors
launch the kernel (built at first use by :mod:`.cuda_build`), CPU tensors
run the plain version.  ``PROBES.launches`` counts kernel launches by
name.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..config import resolve_device
from ..sys.errors import SetupError
from .cuda_build import CSRC, CudaLibrary, KernelError

SOURCE = CSRC / "probes.cu"
NAMES = ("stream_copy", "scaled_copy", "window_copy", "roll_window")
#: K6's factor (``tools/bw_probe.py:54``)
SCALED_COPY_FACTOR = 1.0000001
#: the stream probe's least size in elements (``bench.py:145``) and its
#: rounding: rows of 128 elements, a multiple of 4096 rows (``:162-164``)
STREAM_MIN_ELEMS = 1 << 26
STREAM_LANES, STREAM_TILE_ROWS = 128, 4096
_DTYPES = (torch.float32, torch.float64)
#: K8: most shifts (``csrc/probes.cu``), and the bound on a block's window
#: (T + 2H) L that its 32-bit offsets take
MAX_SHIFTS = 8
MAX_WINDOW = 2 ** 31 - 1


class ProbeKernels(CudaLibrary):
    """The compiled probe library and its launch counters by name."""

    def __init__(self):
        super().__init__(SOURCE)
        self.reset_counts()

    def reset_counts(self) -> None:
        self.launches = dict.fromkeys(NAMES, 0)

    def bind(self, lib) -> None:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for name in ("stream_copy_launch", "scaled_copy_launch"):
            getattr(lib, name).argtypes = [vp, vp, ll, i, i, vp]
        lib.window_copy_launch.argtypes = [ctypes.c_double, vp, vp, ll, i, i,
                                           vp]
        lib.roll_window_launch.argtypes = (
            [ctypes.c_double] + [vp] * 4 + [ll] * 4
            + [ctypes.POINTER(ll), i, i, i, vp])
        for name in NAMES:
            getattr(lib, name + "_launch").restype = i
        lib.probe_max_shifts.argtypes = []
        lib.probe_max_shifts.restype = i
        if lib.probe_max_shifts() != MAX_SHIFTS:
            raise KernelError("MAX_SHIFTS differs between the kernel and "
                              "its wrapper")

    def _run(self, name: str, rc: int) -> None:
        if rc != 0:
            raise KernelError(f"{name} launch failed: cudaError {rc}")
        self.launches[name] += 1

    @staticmethod
    def _stream(x):
        return torch.cuda.current_stream(x.device).cuda_stream

    def stream(self, name, x, out):
        lib = self.load()
        fn = getattr(lib, name + "_launch")
        self._run(name, fn(x.data_ptr(), out.data_ptr(), x.numel(),
                           int(x.dtype == torch.float64), x.device.index,
                           self._stream(x)))
        return out

    def window(self, c, x, out):
        lib = self.load()
        self._run("window_copy", lib.window_copy_launch(
            float(c), x.data_ptr(), out.data_ptr(), x.numel(),
            int(x.dtype == torch.float64), x.device.index,
            self._stream(x)))
        return out

    def roll(self, c, x, prev, next_, out, G, T, H, L, shifts):
        lib = self.load()
        if G > 65535 or (T + 2 * H) * L > MAX_WINDOW:
            raise KernelError(f"roll_window takes at most 65535 blocks of "
                              f"windows below 2^31 elements (got {G} of "
                              f"{(T + 2 * H) * L})")
        ks = (ctypes.c_longlong * len(shifts))(*shifts)
        self._run("roll_window", lib.roll_window_launch(
            float(c), x.data_ptr(), prev.data_ptr(), next_.data_ptr(),
            out.data_ptr(), G, T, H, L, ks, len(shifts),
            int(x.dtype == torch.float64), x.device.index,
            self._stream(x)))
        return out


#: the process-wide compiled library and its launch counters
PROBES = ProbeKernels()


# ------------------------------------------------------------- checks
def _check(t: torch.Tensor, name: str, like: torch.Tensor, shape=None):
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {like.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_vector_aligned(*ts: torch.Tensor) -> None:
    """The 16-byte vector path's requirement on every base pointer; the
    kernels have no scalar path to fall back on."""
    for t in ts:
        if t.data_ptr() % 16:
            raise KernelError(f"base pointer {t.data_ptr():#x} is not "
                              "16-byte aligned (the probe kernels load 16 "
                              "bytes at a time)")


def _out(x, out, shape):
    if out is None:
        return torch.empty(shape, dtype=x.dtype, device=x.device)
    _check(out, "out", x, shape)
    return out


def _stream_args(x, out):
    if x.dtype not in _DTYPES:
        raise TypeError(f"x has dtype {x.dtype}, expected float32 or "
                        "float64")
    _check(x, "x", x)
    return _out(x, out, x.shape)


def window_dims(x, prev, next_, tiles: int):
    """(G, T, H, L) of a window probe's operands: ``x [G T, L]``, ``prev``
    and ``next`` ``[G H, L]``."""
    if x.dim() != 2:
        raise ValueError(f"x must be [G T, L] (got shape {tuple(x.shape)})")
    G = int(tiles)
    rows, L = x.shape
    if G < 1 or rows % G or prev.dim() != 2 or prev.shape[0] % G:
        raise ValueError(f"x [{rows}, {L}] and prev {tuple(prev.shape)} do "
                         f"not split into {G} blocks")
    T, H = rows // G, prev.shape[0] // G
    if x.dtype not in _DTYPES:
        raise TypeError(f"x has dtype {x.dtype}, expected float32 or "
                        "float64")
    _check(x, "x", x)
    _check(prev, "prev", x, (G * H, L))
    _check(next_, "next", x, (G * H, L))
    return G, T, H, L


def _check_shifts(shifts: Sequence[int], H: int, L: int):
    ks = [int(k) for k in shifts]
    if not 1 <= len(ks) <= MAX_SHIFTS:
        raise ValueError(f"roll_window takes 1 to {MAX_SHIFTS} shifts (got "
                         f"{len(ks)})")
    if any(abs(k) > H * L for k in ks):
        raise ValueError(f"shifts {ks} reach beyond the halo of H L = "
                         f"{H * L} elements (the reference would wrap "
                         "around inside its window)")
    return ks


# ----------------------------------------------------- plain versions
def stream_copy_reference(x: torch.Tensor, out=None) -> torch.Tensor:
    """Plain version of K5: a copy of ``x``."""
    out = _stream_args(x, out)
    return out.copy_(x)


def scaled_copy_reference(x: torch.Tensor, out=None) -> torch.Tensor:
    """Plain version of K6: ``x * 1.0000001`` in ``x``'s dtype."""
    out = _stream_args(x, out)
    return torch.mul(x, SCALED_COPY_FACTOR, out=out)


def _windows(x, prev, next_, G, T, H, L):
    """[G, T + 2H, L]: each block's window concat(prev_g, x_g, next_g)."""
    return torch.cat([prev.reshape(G, H, L), x.reshape(G, T, L),
                      next_.reshape(G, H, L)], dim=1)


def window_copy_reference(c: float, x, prev, next_, tiles: int, out=None
                          ) -> torch.Tensor:
    """Plain version of K7: the windows assembled, their middle rows
    times ``c``."""
    G, T, H, L = window_dims(x, prev, next_, tiles)
    out = _out(x, out, x.shape)
    w = _windows(x, prev, next_, G, T, H, L)
    return torch.mul(w[:, H:H + T], float(c), out=out.view(G, T, L)
                     ).view(x.shape)


def roll_window_reference(c: float, x, prev, next_, tiles: int,
                          shifts: Sequence[int], out=None) -> torch.Tensor:
    """Plain version of K8: ``acc = acc + c * w[H L - k : H L - k + T L]``
    over the flat windows, in the order of ``shifts``, from 0."""
    G, T, H, L = window_dims(x, prev, next_, tiles)
    ks = _check_shifts(shifts, H, L)
    out = _out(x, out, x.shape)
    w = _windows(x, prev, next_, G, T, H, L).reshape(G, (T + 2 * H) * L)
    acc = torch.zeros((G, T * L), dtype=x.dtype, device=x.device)
    for k in ks:
        acc = acc + float(c) * w[:, H * L - k:H * L - k + T * L]
    return out.copy_(acc.view(x.shape))


# ------------------------------------------------------------ wrappers
def _dispatch(x):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cuda"


def stream_copy(x: torch.Tensor, out=None) -> torch.Tensor:
    """K5: ``out = x`` (float32 or float64, contiguous).  CUDA tensors
    launch the kernel; CPU tensors run :func:`stream_copy_reference`."""
    if _dispatch(x):
        out = _stream_args(x, out)
        check_vector_aligned(x, out)
        return PROBES.stream("stream_copy", x, out)
    return stream_copy_reference(x, out)


def scaled_copy(x: torch.Tensor, out=None) -> torch.Tensor:
    """K6: ``out = x * 1.0000001``.  CUDA tensors launch the kernel; CPU
    tensors run :func:`scaled_copy_reference`."""
    if _dispatch(x):
        out = _stream_args(x, out)
        check_vector_aligned(x, out)
        return PROBES.stream("scaled_copy", x, out)
    return scaled_copy_reference(x, out)


def window_copy(c: float, x, prev, next_, tiles: int, out=None
                ) -> torch.Tensor:
    """K7 over ``tiles`` blocks, ``c`` a host float.  CUDA tensors launch
    the kernel; CPU tensors run :func:`window_copy_reference`."""
    if _dispatch(x):
        window_dims(x, prev, next_, tiles)
        out = _out(x, out, x.shape)
        check_vector_aligned(x, out)
        return PROBES.window(c, x, out)
    return window_copy_reference(c, x, prev, next_, tiles, out)


def roll_window(c: float, x, prev, next_, tiles: int,
                shifts: Sequence[int], out=None) -> torch.Tensor:
    """K8 over ``tiles`` blocks with the flat ``shifts`` (1 to 8, each
    ``|k| <= H L``, else ``ValueError``), ``c`` a host float.  CUDA tensors
    launch the kernel; CPU tensors run :func:`roll_window_reference`."""
    if _dispatch(x):
        G, T, H, L = window_dims(x, prev, next_, tiles)
        ks = _check_shifts(shifts, H, L)
        out = _out(x, out, x.shape)
        return PROBES.roll(c, x, prev, next_, out, G, T, H, L, ks)
    return roll_window_reference(c, x, prev, next_, tiles, shifts, out)


# -------------------------------------------------------- measurement
def stream_elems(n_box: Optional[int] = None) -> int:
    """The stream probe's size for a box of ``n_box`` elements: bench's
    rule, ``max(n_box, 2^26)`` cut to whole tiles of 4096 rows of 128."""
    rows = max(int(n_box or 0), STREAM_MIN_ELEMS) // STREAM_LANES
    return (rows - rows % STREAM_TILE_ROWS) * STREAM_LANES


def stream_bandwidth(n: Optional[int] = None, dtype=torch.float64,
                     device="cuda", reps: int = 100) -> float:
    """Bytes per second that K5 streams on a card: ``2 n itemsize / t``
    over ``reps`` back-to-back launches between two buffers of
    :func:`stream_elems` ``(n)`` elements, timed with CUDA events after a
    warm-up (counterpart of ``bench.py:144-197``; the events need no
    two-point slope).  It counts the probe's own traffic only.  Raises
    ``SetupError`` off a card: a host clock is no device rate."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise SetupError(f"stream_bandwidth times a CUDA card, not {dev}")
    m = stream_elems(n)
    a = torch.zeros(m, dtype=dtype, device=dev)
    b = torch.empty_like(a)
    with torch.cuda.device(dev):       # the events on the card's stream
        for _ in range(3):
            stream_copy(a, out=b)
            stream_copy(b, out=a)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(reps):
            if i % 2:
                stream_copy(b, out=a)
            else:
                stream_copy(a, out=b)
        e1.record()
        e1.synchronize()
    seconds = e0.elapsed_time(e1) / 1e3 / reps
    return 2.0 * m * a.element_size() / seconds


def box_action_bytes(n_in: int, n_out: int, R: int, synth: bool,
                     n_valid: Optional[int] = None, table_bytes: int = 0,
                     field_rows: int = 0) -> int:
    """Compulsory float64 bytes of one box action over ``n_in`` input
    elements (``n_valid`` of them valid, all by default) and ``n_out``
    outputs, as the kernel takes its inputs: ``p`` and the ``field_rows``
    propensity rows read at valid elements, the propensity tables
    (``table_bytes``) once, ``dp`` written; the mask-reading mode also
    reads the mask byte of every input element and ``R`` violation words
    at each valid one.  At R = 6 with every reaction on a table and every
    element valid: 41 B per element for K1 and 16 for K3, plus the
    tables.  The port's counterpart of bench's traffic model
    (``bench.py:198-206``)."""
    nv = n_in if n_valid is None else int(n_valid)
    per_valid = 8 + 8 * field_rows + (0 if synth else 4 * R)
    return (nv * per_valid + (0 if synth else n_in) + table_bytes
            + 8 * n_out)


def field_box_action_bytes(n_in: int, n_out: int, R: int,
                           synth: bool) -> int:
    """The traffic model of the kernel that read ``R`` propensity fields
    at every element (``p`` and the fields per input element, the
    mask-reading mode also the mask byte and ``R`` violation words;
    ``dp`` written): 89 B per element for K1 and 64 for K3 at R = 6.
    Kept so that roofline fractions stated against it stay readable."""
    per_in = 8 + 8 * R + (0 if synth else 1 + 4 * R)
    return n_in * per_in + 8 * n_out
