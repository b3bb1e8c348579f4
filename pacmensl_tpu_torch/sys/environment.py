"""Runtime environment: process-group set-up, teardown and the mesh.

Counterpart of ``pacmensl_tpu/sys/environment.py`` (the reference's
``PACMENSLInit``/``PACMENSLFinalize`` and RAII ``Environment``,
``src/Sys/Sys.h:62-80``, ``Sys.cpp:31-63,122-197``), which idempotently
start MPI.  The port starts a ``torch.distributed`` process group instead:
NCCL for CUDA, one rank per card, and gloo for processes on the CPU.  Every
rank runs the same program, as MPI ranks do.

Started under ``torchrun`` (``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` in the
environment), :func:`init` joins that group; given an ``init_method``
(``tcp://localhost:<port>``, ``file://<path>``), it joins that rendezvous;
with neither, it starts a group of one rank that needs no rendezvous.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Callable, Optional

import torch
import torch.distributed as dist

_owns_group = False


def init(backend: Optional[str] = None, init_method: Optional[str] = None,
         world_size: Optional[int] = None, rank: Optional[int] = None,
         timeout: Optional[float] = None) -> None:
    """Idempotent start of the default process group (reference
    ``PACMENSLInit``).  ``backend`` defaults to NCCL where CUDA is
    available, else gloo; ``timeout`` is in seconds."""
    global _owns_group
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if timeout is not None:
        kw["timeout"] = timedelta(seconds=float(timeout))
    if init_method is None and "MASTER_ADDR" not in os.environ:
        if world_size not in (None, 1) or rank not in (None, 0):
            raise ValueError("a group of several ranks needs an init_method "
                             "or torchrun's environment")
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0, **kw)
    else:
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            world_size=-1 if world_size is None else int(world_size),
            rank=-1 if rank is None else int(rank), **kw)
    _owns_group = True


def finalize() -> None:
    """Idempotent teardown of a group :func:`init` started (reference
    ``PACMENSLFinalize``)."""
    global _owns_group
    if _owns_group and dist.is_initialized():
        dist.destroy_process_group()
    _owns_group = False


class Environment:
    """Scoped runtime environment (reference RAII ``Environment``)::

        with Environment(backend="nccl") as env:
            mesh = env.mesh()
    """

    def __init__(self, **init_kwargs):
        init(**init_kwargs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        finalize()
        return False

    def mesh(self, device="cuda"):
        """The 1-D mesh of the state axis over the group's ranks
        (:func:`~..parallel.mesh.make_mesh`)."""
        from ..parallel.mesh import make_mesh
        return make_mesh(device)

    @staticmethod
    def sequential_action(fn: Callable[[], None]) -> None:
        """Run ``fn`` on one rank after another, in rank order, behind
        barriers (reference ``sequential_action``, Sys.cpp:83-113)."""
        if not dist.is_initialized():
            fn()
            return
        for r in range(dist.get_world_size()):
            if dist.get_rank() == r:
                fn()
            dist.barrier()
