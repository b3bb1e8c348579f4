"""Build and load the port's CUDA sources.

Each source under ``pacmensl_tpu_torch/csrc`` is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface at first use,
cached under ``pacmensl_tpu_torch/_build/`` by a hash of the source and
the flags, and loaded with ``ctypes``.  ``nvcc`` is taken from
``CUDA_HOME`` (or ``CUDA_PATH``, default ``/usr/local/cuda``), then from
``PATH``.  A missing ``nvcc`` or a failed build raises
:class:`KernelError`; there is no fallback.
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
from typing import Optional, Tuple

from ..sys.errors import PacmenslError

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
#: ``-fmad=false``: no multiply-add contraction, so a kernel rounds every
#: product and sum as its plain version does and its output is bitwise
#: equal to it.  The slice's expansion trajectory is a discrete outcome
#: that rounding-level differences select (PERF.md, Findings).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


class KernelError(PacmenslError):
    """A CUDA kernel failed to build, load or launch."""


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, else the one on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                      "the CUDA kernels cannot be built")


def library_path(source: Path, flags=NVCC_FLAGS) -> Path:
    """Where the build of ``source`` with ``flags`` lies: a name of its
    own for each source text and set of flags."""
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{tag}.so"


def build(source: Path, flags=NVCC_FLAGS) -> Tuple[Path, float, str]:
    """Compile ``source`` unless a build of this exact source and flags
    exists; the library is written to a temporary file and renamed into
    place atomically.  Returns (library path, build seconds, 0 for a
    cached build, nvcc's output)."""
    out = library_path(source, flags)
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc(), *flags, "-o", tmp, str(source)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise KernelError(f"nvcc failed on {source.name} "
                              f"({proc.returncode}):\n{log}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, time.perf_counter() - t0, log


class CudaLibrary:
    """One source's library, built with ``flags`` and loaded at first
    use.  Subclasses declare the C functions' argument types in
    :meth:`bind`."""

    def __init__(self, source: Path, flags=NVCC_FLAGS):
        self.source = source
        self.flags = tuple(flags)
        self.lib = None
        self.path: Optional[Path] = None
        self.build_seconds: Optional[float] = None
        self.build_log = ""

    def bind(self, lib) -> None:
        """Set ``argtypes``/``restype`` of ``lib``'s functions and check
        what the wrapper and the source must agree on."""

    def load(self):
        if self.lib is not None:
            return self.lib
        path, self.build_seconds, self.build_log = build(self.source,
                                                         self.flags)
        lib = ctypes.CDLL(str(path))
        self.bind(lib)
        self.lib, self.path = lib, path
        return lib
