"""The profiler window of a ``--trace 1`` run and its reduction.

The harness marks its own spans with ``torch.profiler.record_function``
(names starting ``bench.``); the window itself is the span
``bench.window``. The reduction reads the profiler's raw events: device
operations (kernels, copies, sets), the host operation that launched each
one (linked by the profiler's correlation id), and the spans. It gives the
device's busy time in the window, each span's device time and launches,
the device operations that took most time, and the longest idle gaps with
the span the host was in.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"
PREFIX = "bench."


def profiler():
    """A profiler of host and device activity (started by the caller)."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def raw_events(prof) -> List[Tuple]:
    """(kind, name, start_ns, end_ns, thread, correlation, linked) of each
    event; kind is "device", "span" or "host"."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if e.device_type().name != "CPU":
            if e.is_user_annotation():
                continue
            out.append(("device", name, start, end, 0, e.correlation_id(), e.linked_correlation_id()))
        else:
            kind = "span" if name.startswith(PREFIX) else "host"
            out.append((kind, name, start, end, e.start_thread_id(), e.correlation_id(), 0))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class _Spans:
    """Innermost span at a host time (spans nest less than 16 deep)."""

    def __init__(self, spans: List[Tuple[str, int, int]], window: Tuple[int, int]):
        self.spans = sorted((s for s in spans if s[0] != WINDOW), key=lambda s: s[1])
        self.starts = [s[1] for s in self.spans]
        self.window = window

    def at(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(-1, i - 16), -1):
            name, a, b = self.spans[j]
            if a <= t <= b:
                return name
        return WINDOW if self.window[0] <= t <= self.window[1] else None


def reduce(events: List[Tuple], top: int = 10) -> Optional[Dict]:
    """The window's numbers from ``raw_events``; None without a window span."""
    windows = [(a, b) for kind, name, a, b, *_ in events if kind == "span" and name == WINDOW]
    if not windows:
        return None
    w0, w1 = windows[0]
    spans = _Spans([(name, a, b) for kind, name, a, b, *_ in events if kind == "span"], (w0, w1))
    # a device op links to the host op (or span) that launched it; the
    # runtime call (cudaLaunchKernel, cuLaunchKernel, ...) shares its own id
    ops = {corr: a for kind, name, a, _, _, corr, _ in events
           if kind != "device" and not name.startswith("cu")}
    runtime = {corr: a for kind, name, a, _, _, corr, _ in events
               if kind == "host" and name.startswith("cu")}
    busy: List[Tuple[int, int]] = []
    by_span: Dict[str, Dict[str, float]] = defaultdict(lambda: {"device_s": 0.0, "launches": 0})
    by_op: Dict[str, float] = defaultdict(float)
    for kind, name, a, b, _, corr, linked in events:
        if kind != "device" or b <= w0 or a >= w1:
            continue
        a, b = max(a, w0), min(b, w1)
        busy.append((a, b))
        by_op[name] += (b - a) / 1e9
        launched = ops.get(linked) if linked else None
        launched = runtime.get(corr) if launched is None else launched
        span = spans.at(launched) if launched is not None else None
        entry = by_span[span[len(PREFIX):] if span else "unattributed"]
        entry["device_s"] += (b - a) / 1e9
        entry["launches"] += 1
    merged = _union(busy)
    busy_s = sum(b - a for a, b in merged) / 1e9
    gaps, edges = [], [(w0, w0)] + merged + [(w1, w1)]
    for (_, prev_end), (nxt_start, _) in zip(edges, edges[1:]):
        if nxt_start > prev_end:
            label = spans.at((prev_end + nxt_start) // 2)
            gaps.append(("idle in " + (label[len(PREFIX):] if label else "no span"),
                         (nxt_start - prev_end) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    return {
        "busy_s": busy_s,
        "window_s": (w1 - w0) / 1e9,
        "spans": {k: dict(v) for k, v in by_span.items()},
        "device_ops": [[n, s] for n, s in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, s] for n, s in gaps[:top]],
    }
