"""Fused vector passes of a BDF step on a CUDA card: loader and wrappers.

The four kernels (``csrc/bdf_step.cu``, see its header for what each
computes and what bounds it) take the arithmetic of a step of
:class:`~..solvers.bdf.BdfSolver` outside GMRES, one launch and one pass
over both parts of the vectors each: :func:`predict`, :func:`rhs`,
:func:`post` and :func:`update`.  They are built and loaded at first use by
:mod:`.cuda_build`.  They take their scalars as arguments, allocate
nothing (the wrappers do) and launch on the current stream without a
sync.

The solver takes them where :func:`fusable` holds for its vectors; else
it runs the PyTorch operations they replace (``BdfSolver._predict``,
``_update_D``, ``_err_norm_dev``), which are their plain versions: the
card's tests hold each kernel bitwise to them.  ``KERNELS.launches``
counts the launches by name.
"""
from __future__ import annotations

import ctypes

import torch

from . import vecops as vo
from .cuda_build import CSRC, CudaLibrary, KernelError

SOURCE = CSRC / "bdf_step.cu"
NAMES = ("predict", "rhs", "post", "update")
#: the highest order the kernels are built for (``BDF_MAX_ORDER``)
MAX_ORDER = 5


class BdfStepKernels(CudaLibrary):
    """The compiled library and its launch counters by name."""

    def __init__(self):
        super().__init__(SOURCE)
        self.reset_counts()

    def reset_counts(self) -> None:
        self.launches = dict.fromkeys(NAMES, 0)

    def bind(self, lib) -> None:
        vp, ll, i, d = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_double)
        lib.bdf_predict_launch.argtypes = (
            [i, vp, ll, vp, vp, ll, vp, ll, vp, vp, ll,
             ctypes.POINTER(d), vp, i, vp])
        lib.bdf_rhs_launch.argtypes = [d] + [vp] * 3 + [ll] + [vp] * 3 + [
            ll, vp, i, vp]
        lib.bdf_post_launch.argtypes = [d] * 3 + [vp] * 4 + [ll] + [vp] * 4 \
            + [ll, vp, i, vp]
        lib.bdf_update_launch.argtypes = [i, vp, ll, vp, ll, vp, ll, vp, ll,
                                          i, vp]
        for name in NAMES:
            getattr(lib, f"bdf_{name}_launch").restype = i
        lib.bdf_max_order.argtypes = []
        lib.bdf_max_order.restype = i
        if lib.bdf_max_order() != MAX_ORDER:
            raise KernelError("the BDF step kernels' highest order differs "
                              "from their wrapper's")

    def run(self, name: str, *args) -> None:
        rc = getattr(self.load(), f"bdf_{name}_launch")(*args)
        if rc != 0:
            raise KernelError(f"bdf_{name} launch failed: cudaError {rc}")
        self.launches[name] += 1


#: the process-wide compiled library and its launch counters
KERNELS = BdfStepKernels()


def fusable(y: vo.FspVector) -> bool:
    """Whether the kernels take the steps of a solve over vectors shaped
    like ``y``: both parts float64 and contiguous on one CUDA device.  In
    a sharded solve they run on each rank's parts (the passes are
    elementwise; the solver reduces the norm and the flags over the
    ranks).  The port's state is float64 throughout (``config.
    DEFAULT_DTYPE``; the box kernels take nothing else), so the float64
    build is the only one."""
    p, s = y.p, y.sinks
    return (p.is_cuda and s.device == p.device
            and p.dtype == s.dtype == torch.float64
            and p.is_contiguous() and s.is_contiguous())


def _dense(x: vo.FspVector) -> vo.FspVector:
    """``x`` with contiguous parts (a copy only where one is not)."""
    return vo.FspVector(p=x.p.contiguous(), sinks=x.sinks.contiguous())


def _stream(t: torch.Tensor):
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def predict(D: vo.FspBasis, q: int, g, psi: vo.FspVector,
            flags: torch.Tensor) -> vo.FspVector:
    """y_pred (new) from ``D[0..q]``, and psi = sum_j g[j - 1] D[j] into
    ``psi``; both ``flags`` set to 1."""
    y = vo.FspVector(p=torch.empty_like(psi.p),
                     sinks=torch.empty_like(psi.sinks))
    KERNELS.run("predict", q, D.p.data_ptr(), D.p.stride(0), y.p.data_ptr(),
                psi.p.data_ptr(), psi.p.numel(), D.sinks.data_ptr(),
                D.sinks.stride(0), y.sinks.data_ptr(), psi.sinks.data_ptr(),
                psi.sinks.numel(), (ctypes.c_double * q)(*g),
                flags.data_ptr(), D.p.device.index, _stream(D.p))
    return y


def rhs(a: vo.FspVector, psi: vo.FspVector, c: float,
        flag: torch.Tensor) -> vo.FspVector:
    """c a - psi (new); ``flag`` set to 0 where an entry is not finite."""
    a = _dense(a)
    out = vo.FspVector(p=torch.empty_like(a.p), sinks=torch.empty_like(
        a.sinks))
    KERNELS.run("rhs", c, a.p.data_ptr(), psi.p.data_ptr(), out.p.data_ptr(),
                a.p.numel(), a.sinks.data_ptr(), psi.sinks.data_ptr(),
                out.sinks.data_ptr(), a.sinks.numel(), flag.data_ptr(),
                a.p.device.index, _stream(a.p))
    return out


def post(y: vo.FspVector, d: vo.FspVector, errc: float, atol: float,
         rtol: float, out: vo.FspVector, sq: vo.FspVector,
         flag: torch.Tensor) -> vo.FspVector:
    """y + d into ``out``, which it returns, and the error norm's terms
    ((errc d) / (rtol |y| + atol))^2 into ``sq``; ``flag`` set to 0 where
    an entry of y + d is not finite."""
    d = _dense(d)
    KERNELS.run("post", errc, atol, rtol, y.p.data_ptr(), d.p.data_ptr(),
                out.p.data_ptr(), sq.p.data_ptr(), y.p.numel(),
                y.sinks.data_ptr(), d.sinks.data_ptr(), out.sinks.data_ptr(),
                sq.sinks.data_ptr(), y.sinks.numel(), flag.data_ptr(),
                y.p.device.index, _stream(y.p))
    return out


def update(D: vo.FspBasis, q: int, d: vo.FspVector) -> None:
    """The accepted step's difference ``d`` pushed into ``D`` at order
    ``q``, in place."""
    d = _dense(d)
    KERNELS.run("update", q, D.p.data_ptr(), D.p.stride(0), d.p.data_ptr(),
                d.p.numel(), D.sinks.data_ptr(), D.sinks.stride(0),
                d.sinks.data_ptr(), d.sinks.numel(), D.p.device.index,
                _stream(D.p))
