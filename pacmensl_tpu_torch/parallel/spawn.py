"""Running a function on the ranks of a new process group, one process a
rank (``torch.multiprocessing`` spawn).

The JAX package runs its multi-device entry points in one process over a
device mesh; the port runs one process per rank (NCCL, one rank a card;
gloo on the CPU).  :func:`run_ranks` starts ``world`` processes and
gathers what each puts on a queue; :func:`run_on_mesh` wraps a function
of a :class:`~.mesh.StateMesh` so that every rank joins the group, makes
its mesh, calls it and reports its result.  A rank that fails, or the
group outlasting its time limit, raises :class:`RankError` here after
every rank is stopped.
"""
from __future__ import annotations

import importlib
import queue as queue_mod
import socket
import sys
import time
from typing import Callable, List

from ..sys.errors import PacmenslError

#: seconds the ranks of a group may take before every rank is stopped
RANK_TIMEOUT = 300


class RankError(PacmenslError):
    """A spawned rank failed or outlasted its time limit."""


def free_port() -> int:
    """A free TCP port on the loopback interface, for a rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, backend: str, target: Callable, args=(),
              timeout: float = RANK_TIMEOUT) -> List[dict]:
    """``target(rank, world, port, backend, *args, queue)`` in ``world``
    spawned processes; the dicts they put on ``queue`` (each with its
    ``"rank"``), by rank.  ``target`` must be importable by name (a
    module's top-level function).  Raises :class:`RankError` where a rank
    exits with another code than 0 or the ranks outlast ``timeout``
    seconds; every rank is stopped before this returns."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target,
                         args=(r, world, port, backend) + tuple(args) + (q,))
             for r in range(world)]
    for pr in procs:
        pr.start()
    out, t0 = {}, time.perf_counter()
    try:
        while len(out) < world:
            try:
                res = q.get(timeout=5)
                out[res["rank"]] = res
            except queue_mod.Empty:
                dead = [pr.exitcode for pr in procs
                        if pr.exitcode not in (None, 0)]
                if dead:
                    raise RankError(f"a rank of {world} ({backend}) exited "
                                    f"with {dead}")
                if time.perf_counter() - t0 > timeout:
                    raise RankError(f"{world} ranks ({backend}) outlasted "
                                    f"{timeout} s")
        for pr in procs:
            pr.join(timeout=60)
            if pr.exitcode != 0:
                raise RankError(f"a rank of {world} ({backend}) exited with "
                                f"{pr.exitcode}")
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.terminate()
                pr.join()
    return [out[r] for r in range(world)]


def _mesh_rank(rank, world, port, backend, device, module, name, kwargs,
               timeout, queue):
    """One rank of :func:`run_on_mesh`: join the group, make the mesh,
    call ``module.name(mesh, **kwargs)``, put ``{"rank", "result"}``."""
    import pacmensl_tpu_torch as pt
    pt.environment.init(backend=backend, world_size=world, rank=rank,
                        init_method=f"tcp://127.0.0.1:{port}",
                        timeout=timeout)
    try:
        fn = getattr(importlib.import_module(module), name)
        mesh = pt.make_mesh(device)
        queue.put({"rank": rank, "result": fn(mesh, **kwargs)})
    finally:
        pt.environment.finalize()


def run_on_mesh(fn: Callable, world: int, device="cuda",
                timeout: float = RANK_TIMEOUT, **kwargs) -> list:
    """``fn(mesh, **kwargs)`` on every rank of a new group of ``world``
    spawned processes (NCCL on ``device="cuda"``, rank r on card r; gloo
    on ``"cpu"``); the results by rank.  ``fn`` must be a module's
    top-level function; its results must pickle."""
    import torch
    from ..config import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise RankError(f"{world} NCCL ranks need {world} cards, "
                        f"{torch.cuda.device_count()} visible")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        # built once here; the ranks load the library from the cache
        from ..ops.box_kernel import KERNEL
        KERNEL.load()
    module = fn.__module__
    if module == "__main__":            # run with ``python -m <module>``
        module = sys.modules["__main__"].__spec__.name
    res = run_ranks(world, backend, _mesh_rank,
                    (dev.type, module, fn.__name__, kwargs, timeout),
                    timeout=timeout)
    return [r["result"] for r in res]
