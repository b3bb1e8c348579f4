"""Fused box-action kernel: CUDA loader, wrapper and plain PyTorch version.

Counterpart of ``pacmensl_tpu/ops/pallas_box.py`` (``PallasBoxKernel``).
The kernel (``csrc/box_action.cu``, see its header for what it computes and
what bounds it) is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use, cached under
``pacmensl_tpu_torch/_build/`` by a hash of the source and flags, and
loaded with ``ctypes``.  A failed build or launch raises; there is no
fallback.

:func:`box_action` dispatches on the device of its tensors: CUDA tensors
launch the kernel, CPU tensors run :func:`box_action_reference`, the plain
PyTorch version of the same function (which the CPU tests pin to the
reference package and ``chip_smoke.py`` compares the kernel with).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..sys.errors import PacmenslError
from .stencil import shift_nd

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "box_action.cu"
BUILD_DIR = _PKG / "_build"
#: ``-fmad=false``: no multiply-add contraction, so the kernel rounds every
#: product and sum as its plain version does and ``dp`` is bitwise equal to
#: it.  The slice's expansion trajectory is a discrete outcome that
#: rounding-level differences select (PERF.md, Findings).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# Fixed maxima of the kernel's parameter struct (csrc/box_action.cu).
MAX_R, MAX_S, MAX_NC = 32, 8, 32
#: most blocks of a launch: 8 on each of an H100 SXM's 132 SMs.  A fixed
#: grid gives every card the same sink reduction order, so the sinks are
#: bitwise reproducible across cards as well as across launches.
GRID_BLOCKS = 1056


class KernelError(PacmenslError):
    """The CUDA kernel failed to build, load or launch."""


class _BoxParams(ctypes.Structure):
    _fields_ = [("c", ctypes.c_double * MAX_R),
                ("kflat", ctypes.c_longlong * MAX_R),
                ("shape", ctypes.c_longlong * MAX_S),
                ("stoich", (ctypes.c_int * MAX_S) * MAX_R),
                ("n", ctypes.c_longlong),
                ("R", ctypes.c_int),
                ("S", ctypes.c_int),
                ("nc", ctypes.c_int)]


class BoxGeometry:
    """Static description of one box action: capacity shape, per-reaction
    moves and the constraint count, with the kernel's flat source offsets
    ``k_r = sum_d s_rd * stride_d``."""

    def __init__(self, shape: Sequence[int], stoich, num_constraints: int):
        self.shape = tuple(int(s) for s in shape)
        self.stoich = np.atleast_2d(np.asarray(stoich, dtype=np.int64))
        self.nc = int(num_constraints)
        self.n = int(np.prod(self.shape))
        R, S = self.stoich.shape
        if S != len(self.shape):
            raise ValueError("stoichiometry and shape disagree on species")
        strides = [int(np.prod(self.shape[d + 1:])) for d in range(S)]
        self.kflat = [int(sum(int(self.stoich[r, d]) * strides[d]
                              for d in range(S))) for r in range(R)]
        self._params: Optional[_BoxParams] = None

    @property
    def num_reactions(self) -> int:
        return self.stoich.shape[0]

    def params(self, c) -> _BoxParams:
        """The kernel's parameter struct with coefficients ``c``."""
        R, S = self.stoich.shape
        if R > MAX_R or S > MAX_S or self.nc > MAX_NC:
            raise KernelError(
                f"box kernel takes at most {MAX_R} reactions, {MAX_S} "
                f"species and {MAX_NC} constraints (got {R}, {S}, "
                f"{self.nc})")
        if self._params is None:
            prm = _BoxParams()
            for r in range(R):
                prm.kflat[r] = self.kflat[r]
                for d in range(S):
                    prm.stoich[r][d] = int(self.stoich[r, d])
            for d in range(S):
                prm.shape[d] = self.shape[d]
            prm.n, prm.R, prm.S, prm.nc = self.n, R, S, self.nc
            self._params = prm
        prm = self._params
        for r, v in enumerate(c):
            prm.c[r] = float(v)
        return prm


class BoxActionKernel:
    """The compiled library, built and loaded at first launch, and the
    launch counters.  ``launches`` counts kernel launches;
    ``plain_cuda_calls`` counts calls of the plain version on CUDA
    tensors (the solve path makes none)."""

    def __init__(self):
        self.lib = None
        self.path: Optional[Path] = None
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self.launches = 0
        self.plain_cuda_calls = 0

    def reset_counts(self) -> None:
        self.launches = 0
        self.plain_cuda_calls = 0

    # ------------------------------------------------------------ build
    @staticmethod
    def _nvcc() -> str:
        home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
            or "/usr/local/cuda"
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
        found = shutil.which("nvcc")
        if found:
            return found
        raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on "
                          "PATH); the box kernel cannot be built")

    def build(self) -> Path:
        """Compile the kernel unless a build of this exact source exists;
        the library is written to a temporary file and renamed into place
        atomically."""
        src = SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                             ).hexdigest()[:16]
        out = BUILD_DIR / f"box_action_{tag}.so"
        if out.exists():
            self.build_seconds = 0.0
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [self._nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise KernelError(
                    f"nvcc failed ({proc.returncode}):\n{self.build_log}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.build_seconds = time.perf_counter() - t0
        return out

    def load(self):
        if self.lib is not None:
            return self.lib
        path = self.build()
        lib = ctypes.CDLL(str(path))
        lib.box_action_params_size.argtypes = []
        lib.box_action_params_size.restype = ctypes.c_int
        lib.box_action_threads.argtypes = []
        lib.box_action_threads.restype = ctypes.c_int
        lib.box_action_launch.argtypes = (
            [ctypes.POINTER(_BoxParams)] + [ctypes.c_void_p] * 7
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.box_action_launch.restype = ctypes.c_int
        size = lib.box_action_params_size()
        if size != ctypes.sizeof(_BoxParams):
            raise KernelError(f"parameter struct size mismatch: kernel "
                              f"{size} B, wrapper "
                              f"{ctypes.sizeof(_BoxParams)} B")
        self.threads = lib.box_action_threads()
        self.lib, self.path = lib, path
        return lib

    # ----------------------------------------------------------- launch
    def launch(self, c, p, mask, a, viol, geom: BoxGeometry
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        lib = self.load()
        dev = p.device
        R, n, nc = geom.num_reactions, geom.n, geom.nc
        _check(p, (n,), torch.float64, dev, "p")
        _check(mask, (n,), torch.uint8, dev, "mask")
        _check(a, (R, n), torch.float64, dev, "a")
        _check(viol, (R, n), torch.int32, dev, "viol")
        c = [float(v) for v in (c.tolist() if torch.is_tensor(c) else c)]
        if len(c) != R:
            raise ValueError(f"c has {len(c)} entries, expected {R}")
        prm = geom.params(c)
        nblocks = max(1, min(-(-n // self.threads), GRID_BLOCKS))
        dp = torch.empty(n, dtype=torch.float64, device=dev)
        part = torch.empty(nblocks * max(nc, 1), dtype=torch.float64,
                           device=dev)
        sinks = torch.empty(max(nc, 1), dtype=torch.float64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.box_action_launch(
            ctypes.byref(prm), p.data_ptr(), mask.data_ptr(), a.data_ptr(),
            viol.data_ptr(), dp.data_ptr(), part.data_ptr(),
            sinks.data_ptr(), nblocks, dev.index, stream)
        if rc != 0:
            raise KernelError(f"box_action launch failed: cudaError {rc}")
        self.launches += 1
        return dp, sinks[:nc]


def _check(t: torch.Tensor, shape, dtype, device, name: str) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


#: the process-wide compiled library and its launch counters
KERNEL = BoxActionKernel()


def box_action_reference(c, p, mask, a, viol, geom: BoxGeometry
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: zero-filled box shifts
    (``shift_nd``) and dense masked sink sums, in the kernel's order of
    accumulation over reactions."""
    if p.is_cuda:
        KERNEL.plain_cuda_calls += 1
    c = [float(v) for v in (c.tolist() if torch.is_tensor(c) else c)]
    shape = geom.shape
    mb = mask.reshape(shape) != 0
    pb = p.reshape(shape)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    dp = torch.zeros_like(pb)
    sinks = [zero] * geom.nc
    for r in range(geom.num_reactions):
        ap = torch.where(mb, a[r].reshape(shape) * pb, zero)
        inflow = torch.where(mb, shift_nd(ap, geom.stoich[r]), zero)
        dp = dp + c[r] * (inflow - ap)
        bits = viol[r].reshape(shape)
        for cc in range(geom.nc):
            sel = ((bits >> cc) & 1) != 0
            sinks[cc] = sinks[cc] + c[r] * torch.where(sel, ap, zero).sum()
    sk = (torch.stack(sinks) if geom.nc
          else torch.zeros(0, dtype=p.dtype, device=p.device))
    return dp.reshape(-1), sk


def box_action(c, p, mask, a, viol, geom: BoxGeometry
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dp, sinks)`` of the truncated generator applied to ``p``.

    ``c [R]`` time coefficients (host floats or a CPU tensor), ``p [n]``
    float64, ``mask [n]`` uint8, ``a [R, n]`` float64 propensity fields,
    ``viol [R, n]`` int32 violation bits.  CUDA tensors launch the kernel;
    CPU tensors run :func:`box_action_reference`."""
    if p.device.type == "cuda":
        return KERNEL.launch(c, p, mask, a, viol, geom)
    if p.device.type == "cpu":
        return box_action_reference(c, p, mask, a, viol, geom)
    raise ValueError(f"unsupported device {p.device}")
