"""One run of one cell: set-up, the measured window, the metrics and the
comparison with the plain reference.  The cell names its configuration
and its traffic mix, the mix the kind of request
(``requests/<kind>.py``), and ``BENCHMARK.json`` the per-layer metrics
(``metrics/<name>.py``), each found by its name.  :mod:`fspbench.run` is
the command line around it; the tests drive it on the host at a small
size."""
from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from . import config, trace as tr, traffic
from .config import ROOT

REPO = ROOT.parent

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "pacmensl_tpu")


@dataclass
class SolveRecord:
    seconds: float
    events: Dict[str, tuple]       # EventLog name -> (count, seconds)
    n_states: int
    backend: str
    capacity: tuple                # the box's capacity ((): ELL)
    peak_bytes: int

    def event_s(self, name: str) -> float:
        return self.events.get(name, (0, 0.0))[1]

    def event_count(self, name: str) -> int:
        return self.events.get(name, (0, 0.0))[0]


@dataclass
class Context:
    """What the per-layer metrics read (``metrics/<name>.py``)."""
    solves: List[SolveRecord] = field(default_factory=list)
    trace: Optional[tr.Trace] = None
    actions: Optional[tr.ActionLog] = None

    def per_solve(self, f: Callable[[SolveRecord], float]):
        if not self.solves:
            return None
        return sum(float(f(s)) for s in self.solves) / len(self.solves)


def benchmark() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _load(path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    return _load(ROOT / "metrics" / f"{name}.py",
                 f"fspbench_metric_{name}").read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def request_kind(name: str):
    """The module ``requests/<name>.py``: how the program serves a request
    of that kind and how the reference judges its answer."""
    return _load(ROOT / "requests" / f"{name}.py", f"fspbench_request_{name}")


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, log=print, overrides: dict = None,
             fault: Callable = None) -> dict:
    """The result line of one run.  ``overrides``: configuration keys
    replaced (the tests' small sizes); ``fault``: a context manager
    factory that breaks the timed path (the tests' faults)."""
    from . import port
    device = torch.device(device)
    bench = benchmark()
    cell = cell_of(bench, cell_name)
    cfg = config.load(cell["config"])
    if overrides:
        cfg.data.update(overrides)
    mix = traffic.load(cell["traffic"])
    kind = request_kind(mix["request"])

    # ---- set-up: the kernels' builds and loads, and short requests of
    # this configuration (the warm-up)
    _reset_peak(device)
    t_warm = time.perf_counter()
    kind.warm_up(cfg, mix, device)
    _sync(device)
    warm_s = time.perf_counter() - t_warm
    build_s = port.build_seconds()
    peak = _peak(device)
    gc.collect()

    # ---- the window: whole requests, one caller, closed loop
    ctx = Context()
    answers = []
    gen = traffic.requests(seed, cfg.num_reactions)
    prof = tr.profile() if trace else None
    wrapping = (tr.wraps(port.operator_classes(), port.event_log_class(),
                         port.action_work, tr.ActionLog())
                if trace else None)
    broken = fault() if fault is not None else None
    failed = 0
    port.reset_kernel_counts()
    if broken is not None:
        broken.__enter__()
    if trace:
        ctx.actions = wrapping.__enter__()
        prof.__enter__()
        from torch.profiler import record_function
        window_span = record_function("fspbench.window")
        window_span.__enter__()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    t_end = t0
    while t_end - t0 < seconds:
        j, f = next(gen)
        _reset_peak(device)
        ts = time.perf_counter()
        try:
            s, answer = kind.serve(cfg, mix, f, device)
            _sync(device)
        except Exception as e:          # a failed request is counted
            failed += 1
            t_end = time.perf_counter()
            log(f"request {len(answers) + failed} failed: {e!r}",
                file=sys.stderr)
            continue
        t_end = time.perf_counter()
        rec = SolveRecord(seconds=t_end - ts, **port.record(s),
                          n_states=len(answer["states"]),
                          peak_bytes=_peak(device))
        ctx.solves.append(rec)
        answers.append((f, answer))
        log(f"request {len(answers) - 1} (cycle {j}): {rec.seconds!r} s, "
            f"{rec.n_states} states, {rec.backend} {rec.capacity}, "
            f"{rec.event_count('StatePartitioning')} expansions, "
            f"{rec.event_count('RHSEvaluation')} RHS evaluations, ODE "
            f"{rec.event_s('ODESolve'):.3f} s, peak {rec.peak_bytes}",
            file=sys.stderr)
        del s, answer
    n_done = len(ctx.solves)
    if trace:
        window_span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        wrapping.__exit__(None, None, None)
    if broken is not None:
        broken.__exit__(None, None, None)
    launches = port.kernel_launches()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    peak = max([peak] + [s.peak_bytes for s in ctx.solves])

    # ---- the measured numbers
    result = {"correct": False, "attempted": n_done + failed,
              "failed": failed, "metrics": {}}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    times = [s.seconds for s in ctx.solves]
    log(f"set-up {setup_s!r} s: warm-up {warm_s!r} s, of which the box "
        f"kernel's build {build_s!r} s (0: built by an earlier run)",
        file=sys.stderr)
    if times:
        log(f"solves {n_done}: min {min(times)!r} median "
            f"{statistics.median(times)!r} max {max(times)!r} s; box kernel "
            f"launches {launches}; card {power_limit()}", file=sys.stderr)
    if trace:
        t_red = time.perf_counter()
        ctx.trace = tr.reduce(tr.events_of(prof))
        log(f"trace reduced in {time.perf_counter() - t_red:.1f} s",
            file=sys.stderr)
        del prof
        flops = sum(ctx.actions.flops)
        log(f"operator actions {len(ctx.actions.bytes)}: bytes "
            f"{sum(ctx.actions.bytes)!r} flops {flops!r} (frozen count)",
            file=sys.stderr)
        for m in bench["per_layer"]:
            if cell_name not in m.get("workloads", [cell_name]):
                continue
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v),
                                                "unit": units[m["name"]]}
    else:
        if n_done:
            result["metrics"]["solve_s"] = {
                "value": (t_end - t0) / n_done, "unit": units["solve_s"]}
        result["metrics"]["setup_s"] = {"value": setup_s,
                                        "unit": units["setup_s"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "host"),
           "count": 1, "memory_peak_bytes": peak}
    if trace and ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = {
            "device_ops": [[n, v] for n, v in ctx.trace.device_ops],
            "idle_gaps": [[n, v] for n, v in ctx.trace.idle_gaps]}
    result["device"] = dev
    result["setup"] = {"build_s": build_s, "warm_up_s": warm_s}

    # ---- the comparison, once the window has closed and the program's
    # state is freed: one solve drawn from the seed against the reference
    del ctx
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = {}
    if answers:
        k = int(traffic.rng(seed, 1).integers(len(answers)))
        f, answer = answers[k]
        del answers
        t_ref = time.perf_counter()
        ref = kind.reference_solve(cfg, mix, f, device)
        got = kind.compare(answer, ref)
        log(f"reference: request {k}, {time.perf_counter() - t_ref:.1f} s, "
            f"{kind.describe(ref, got)}", file=sys.stderr)
        for name, limit in kind.limits(cfg).items():
            checks[name] = {"value": got[name], "limit": limit}
    result["correct"] = (bool(checks) and failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}",
            file=sys.stderr)
    result["checks"] = checks
    return result
