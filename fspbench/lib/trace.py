"""The traced run: the benchmark's own spans around calls into the
program, and the reduction of ``torch.profiler``'s device trace to the
numbers the per-layer metrics read.

Spans are ``torch.profiler.record_function`` ranges named ``fspbench.*``
(the window, each solve, each operator action) and ``phase.<name>`` (the
program's own ``EventLog`` phases, whose timer the benchmark wraps).
Nothing is written to disk: the profiler's events are read in memory.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: the published HBM3 bandwidth of one H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12

SPAN_PREFIXES = ("fspbench.", "phase.")


@dataclass
class ActionLog:
    """What the wrap around each operator action records: the host
    seconds of the call (enqueue, no synchronisation) and the frozen
    count of its work (:mod:`.counts`)."""
    host_s: List[float] = field(default_factory=list)
    bytes: List[float] = field(default_factory=list)
    flops: List[float] = field(default_factory=list)


@contextlib.contextmanager
def wraps(operator_classes, event_log_class, count, log: ActionLog):
    """Wrap every operator class's ``action`` (a span, its host time and
    its work count from ``count(op)``) and the program's phase timer
    (``EventLog.timed``: a span per phase) until the block ends."""
    from torch.profiler import record_function
    saved = [(cls, cls.action) for cls in operator_classes]
    timed = event_log_class.timed

    def wrap(orig):
        def action(self, *a, **k):
            b, f = count(self)
            with record_function("fspbench.action"):
                t0 = time.perf_counter()
                out = orig(self, *a, **k)
                log.host_s.append(time.perf_counter() - t0)
            log.bytes.append(b)
            log.flops.append(f)
            return out
        return action

    @contextlib.contextmanager
    def traced_timed(self, name):
        with record_function(f"phase.{name}"), timed(self, name):
            yield

    try:
        for cls, orig in saved:
            cls.action = wrap(orig)
        event_log_class.timed = traced_timed
        yield log
    finally:
        for cls, orig in saved:
            cls.action = orig
        event_log_class.timed = timed


@dataclass
class Trace:
    """The reduction of one traced window."""
    window_s: float
    busy_s: float
    action_device_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _is_device(e) -> bool:
    return "CUDA" in str(e.device_type())


def _union(intervals):
    """Merged ``[start, end]`` intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce(events, top: int = 10) -> Optional[Trace]:
    """Reduce the profiler's events (``prof.profiler.kineto_results
    .events()``, or objects with the same methods): the device's busy
    time inside the ``fspbench.window`` span, the device time of the
    operations launched inside ``fspbench.action`` spans, the device
    operations that took most time, and the idle gaps grouped by the
    innermost span open on the host.  None where the trace holds no
    window span or no device operation."""
    spans, ops, launch_at = [], [], {}
    for e in events:
        name = e.name()
        if name.startswith(SPAN_PREFIXES):
            if not _is_device(e):
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              name))
        elif _is_device(e):
            ops.append((e.start_ns(), e.duration_ns(), name,
                        e.correlation_id()))
        elif name.startswith("cu"):
            # the runtime call that launched a device operation: the
            # operation carries the same (CUPTI) correlation id
            launch_at[e.correlation_id()] = e.start_ns()
    windows = [s for s in spans if s[2] == "fspbench.window"]
    if not windows or not ops:
        return None
    w0, w1, _ = windows[0]
    ops = [o for o in ops if o[0] < w1 and o[0] + o[1] > w0]
    if not ops:
        return None
    busy = _union([(max(s, w0), min(s + d, w1)) for s, d, _, _ in ops])
    busy_ns = sum(e - s for s, e in busy)
    # device time of the operations launched inside an action span
    acts = sorted((s, e) for s, e, n in spans if n == "fspbench.action")
    starts = [s for s, _ in acts]
    in_action = 0
    by_name: Dict[str, int] = {}
    for s, d, name, corr in ops:
        by_name[name] = by_name.get(name, 0) + d
        t = launch_at.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= acts[i][1]:
            in_action += d
    # idle gaps, each labelled with the innermost host span open at its
    # middle (the spans of one thread nest), summed by label
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    host = sorted((s, e, n) for s, e, n in spans if n != "fspbench.window")
    idle: Dict[str, int] = {}
    stack: List[Tuple[int, str]] = []
    k = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) // 2
        while k < len(host) and host[k][0] <= mid:
            while stack and stack[-1][0] < host[k][0]:
                stack.pop()
            stack.append((host[k][1], host[k][2]))
            k += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        label = stack[-1][1] if stack else "fspbench.window"
        idle[label] = idle.get(label, 0) + (b - a)
    return Trace(
        window_s=(w1 - w0) / 1e9,
        busy_s=busy_ns / 1e9,
        action_device_s=in_action / 1e9,
        device_ops=[(n, v / 1e9) for n, v in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[(n, v / 1e9) for n, v in
                   sorted(idle.items(), key=lambda kv: -kv[1])[:top]])


def profile():
    """A profiler of the host and the card, kept in memory."""
    from torch.profiler import ProfilerActivity, profile as prof
    return prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def events_of(prof):
    return prof.profiler.kineto_results.events()
