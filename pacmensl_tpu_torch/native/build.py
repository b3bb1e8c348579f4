"""Build and load the native state directory (``fastset.cpp``).

Counterpart of ``pacmensl_tpu/native/build.py``.  The source is compiled
with ``g++`` at first use into a shared library with a plain C interface,
cached under ``pacmensl_tpu_torch/_build/`` by a hash of the source and the
flags (written to a temporary file and renamed into place, so concurrent
processes never load a torn library), and loaded with ``ctypes``.  A
missing compiler or a failed build raises :class:`NativeBuildError`: the
compressed state set has no silent fallback (its numpy directory,
:class:`~.fastset.PlainSet`, is the plain version the tests hold it
against).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from ..sys.errors import PacmenslError

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "fastset.cpp"
BUILD_DIR = _HERE.parent / "_build"
#: no ``-march=native``: the cached library must run on any x86-64 host
#: that shares the checkout
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


class NativeBuildError(PacmenslError):
    """The native state directory failed to build or load."""


def _build() -> Path:
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"fastset_{tag}.so"
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeBuildError("g++ not found (set CXX): the native state "
                               "directory cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(f"{cxx} failed on {SOURCE.name} "
                                   f"({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_i64 = ctypes.c_int64
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.fastset_create.argtypes = [c_i64]
    lib.fastset_create.restype = ctypes.c_void_p
    lib.fastset_destroy.argtypes = [ctypes.c_void_p]
    lib.fastset_destroy.restype = None
    lib.fastset_size.argtypes = [ctypes.c_void_p]
    lib.fastset_size.restype = c_i64
    lib.fastset_insert.argtypes = [ctypes.c_void_p, p_i64, c_i64, p_u8]
    lib.fastset_insert.restype = c_i64
    lib.fastset_lookup.argtypes = [ctypes.c_void_p, p_i64, c_i64, p_i64]
    lib.fastset_lookup.restype = None
    lib.fastset_sub2ind.argtypes = [p_i64, c_i64, p_i64, c_i64, p_i64]
    lib.fastset_sub2ind.restype = None
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built at the first call; raises
    :class:`NativeBuildError` when it cannot be built or loaded."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                path = _build()
                try:
                    _lib = _bind(ctypes.CDLL(str(path)))
                except OSError as e:
                    raise NativeBuildError(f"cannot load {path}: {e}")
    return _lib
