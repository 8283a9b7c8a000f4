"""Named step timing, and program spans on the torch profiler's clock.

Port of image_transformation_tpu/core/timing.py. Same API and
``time_log.txt`` format as the reference StepTimer: durations accumulate
across repeated step names, each step echoes ``[TIME] name: X.XXXs``, and
``write_to_file`` persists one ``name: X.XXXs`` line per step.

:func:`span` marks a layer boundary of the program. While a torch profiler
records, a span opens a profiler range of its name (so it shows in the
trace's timeline; the profiler's light range where torch has it, about a
tenth of ``record_function``'s cost), stamps its host start and end with
``time.time_ns()`` (the profiler's clock: Unix-epoch nanoseconds), and keeps
a record with its parent span and the id of the step it belongs to (each
outermost span starts a step). Given a CUDA ``device``, it also records a
timing event pair on that device's current stream; the pair is read once its
end has completed, or when :func:`span_summary` is taken, so a span never
synchronises the host. With no profiler recording a span is one flag check:
no range, no clock read, no event, no record. Each StepTimer step is such a
span.
"""

from __future__ import annotations

import array
import collections
import contextlib
import itertools
import math
import statistics
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

#: the profiler range a span opens
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", record_function)
#: the most span records kept; older ones drop out first (their counts stay)
SPAN_RECORDS = 1 << 16
#: the fields of a span record, as ``span_summary`` returns them
FIELDS = ("name", "step", "parent", "start_ns", "end_ns", "child_ns", "device_ms")

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
# The kept records are columns of plain numbers in a ring of SPAN_RECORDS
# slots, so that a closed span leaves no object behind for the garbage
# collector: under a long trace, records kept as objects bring its full
# collections sooner (on an H100, one of ~70 ms inside a 30 s traced window
# of the batched step, against none without spans).
_names: List[str] = []  # span names by id
_name_ids: Dict[str, int] = {}
_ints = array.array("q")  # per slot: name id, step, parent's name id or -1, start, end, child ns
_device_ms = array.array("d")  # per slot: device ms, NaN without
_written = 0  # records written since the last reset
_counts: collections.Counter = collections.Counter()
_pending: collections.deque = collections.deque()  # (record number, device, start, end)
_pool: Dict[torch.device, List] = collections.defaultdict(list)  # idle event pairs
_local = threading.local()  # .stack: this thread's open spans
_step_ids = itertools.count(1)


def _name_id(name: str) -> int:
    i = _name_ids.get(name)
    if i is None:
        i = _name_ids[name] = len(_names)
        _names.append(name)
    return i


def _write(ints) -> int:
    """Keep one record with no device ms yet (oldest out past SPAN_RECORDS);
    returns its number."""
    global _written
    slot = _written % SPAN_RECORDS
    if _written < SPAN_RECORDS:
        _ints.extend(ints)
        _device_ms.append(math.nan)
    else:
        _ints[6 * slot:6 * slot + 6] = array.array("q", ints)
        _device_ms[slot] = math.nan
    _written += 1
    return _written - 1


def _read_pair(entry, wait: bool) -> bool:
    """Fill ``entry``'s record with its device ms (if still kept) and return
    the pair to the pool; False (and nothing done) if its end has not
    completed and not ``wait``."""
    number, dev, start, end = entry
    if wait:
        end.synchronize()
    elif not end.query():
        return False
    if number >= _written - SPAN_RECORDS:
        _device_ms[number % SPAN_RECORDS] = start.elapsed_time(end)
    _pool[dev].append((start, end))
    return True


class _Span:
    __slots__ = ("name", "device", "step", "parent", "start_ns", "child_ns", "range", "events")

    def __init__(self, name: str, device: Optional[torch.device]) -> None:
        self.name = name
        self.device = device if device is not None and device.type == "cuda" else None
        self.child_ns = 0
        self.events = None

    def __enter__(self) -> None:
        stack = _local.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        self.parent = parent.name if parent else None
        self.step = parent.step if parent else next(_step_ids)
        stack.append(self)
        self.start_ns = time.time_ns()
        self.range = _Range(self.name)
        self.range.__enter__()
        if self.device is not None:
            with _lock:
                pool = _pool[self.device]
                pair = pool.pop() if pool else (torch.cuda.Event(enable_timing=True),
                                                 torch.cuda.Event(enable_timing=True))
            pair[0].record(torch.cuda.current_stream(self.device))
            self.events = pair

    def __exit__(self, *exc) -> bool:
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        self.range.__exit__(*exc)
        end_ns = time.time_ns()
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += end_ns - self.start_ns
        with _lock:
            parent = -1 if self.parent is None else _name_id(self.parent)
            number = _write((_name_id(self.name), self.step, parent, self.start_ns, end_ns,
                             self.child_ns))
            _counts[self.name] += 1
            if self.events is not None:
                _pending.append((number, self.device, *self.events))
            while _pending and _read_pair(_pending[0], wait=False):
                _pending.popleft()
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A context manager marking one layer boundary of the program as the
    span ``name``; a CUDA ``device`` adds a device interval. It records
    only while a torch profiler records (see the module docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def launch_range(name: str):
    """A profiler range ``name`` to open around a hand-written kernel's
    launch, while a torch profiler records (else nothing). The trace links
    a kernel to the innermost such range open at its launch, as it links a
    torch op's kernels to the op; without one, a ctypes launch links to the
    enclosing program span, which may have opened before a caller's own
    range around the wrapper."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Range(name)


def _quantile(s: List[float], q: float) -> float:
    """The q-quantile of sorted ``s``, linear between order statistics."""
    r = (len(s) - 1) * q
    lo = int(r)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (r - lo)


def span_summary() -> Dict:
    """``{"spans": {name: stats}, "records": [...]}`` of the kept spans.

    Per name: ``count`` (every span closed since the last reset, kept
    records or not), ``host_ms_p50``/``host_ms_p95``,
    ``device_ms_p50``/``device_ms_p95``/``device_ms_sum`` (None without
    device intervals; the sum over the kept records) and
    ``self_host_ms_p50`` (the duration less the part its child spans
    cover). Waits for the device intervals not yet read."""
    with _lock:
        while _pending:
            _read_pair(_pending.popleft(), wait=True)
        records = []
        for number in range(max(0, _written - SPAN_RECORDS), _written):
            slot = number % SPAN_RECORDS
            name, step, parent, start, end, child = _ints[6 * slot:6 * slot + 6]
            dev = _device_ms[slot]
            records.append(dict(zip(FIELDS, (
                _names[name], step, None if parent < 0 else _names[parent], start, end,
                child, None if math.isnan(dev) else dev))))
        counts = dict(_counts)
    by_name: Dict[str, List[Dict]] = collections.defaultdict(list)
    for r in records:
        by_name[r["name"]].append(r)
    spans = {}
    for name, rs in by_name.items():
        host = sorted((r["end_ns"] - r["start_ns"]) / 1e6 for r in rs)
        own = [(r["end_ns"] - r["start_ns"] - r["child_ns"]) / 1e6 for r in rs]
        dev = sorted(r["device_ms"] for r in rs if r["device_ms"] is not None)
        spans[name] = {
            "count": counts[name],
            "host_ms_p50": statistics.median(host),
            "host_ms_p95": _quantile(host, 0.95),
            "device_ms_p50": statistics.median(dev) if dev else None,
            "device_ms_p95": _quantile(dev, 0.95) if dev else None,
            "device_ms_sum": math.fsum(dev) if dev else None,
            "self_host_ms_p50": statistics.median(own),
        }
    return {"spans": spans, "records": records}


def reset_spans() -> None:
    """Drop every span record and count (device intervals pending included)."""
    global _written
    with _lock:
        del _ints[:], _device_ms[:]
        _written = 0
        _counts.clear()
        _pending.clear()


class StepTimer:
    """Collects named wall-clock durations in seconds."""

    def __init__(self) -> None:
        self._durations: Dict[str, float] = {}

    @contextmanager
    def time_step(self, name: str, echo: bool = True) -> Iterator[None]:
        start = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            duration = time.perf_counter() - start
            self._durations[name] = self._durations.get(name, 0.0) + duration
            if echo:
                print(f"[TIME] {name}: {duration:.3f}s")

    def get(self, name: str) -> Optional[float]:
        return self._durations.get(name)

    def summary(self) -> Dict[str, float]:
        return dict(self._durations)

    def to_lines(self) -> List[str]:
        return [f"{k}: {v:.3f}s" for k, v in self._durations.items()]

    def write_to_file(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for line in self.to_lines():
                f.write(line + "\n")

    def load_from_file(self, path) -> None:
        """Seed durations from a previous run's time_log.txt (resume path:
        the final write would otherwise replace the whole log with only
        post-resume steps). Unparseable lines are ignored."""
        try:
            text = open(path, "r", encoding="utf-8").read()
        except OSError:
            return
        for line in text.splitlines():
            name, sep, value = line.rpartition(": ")
            if sep and value.endswith("s"):
                try:
                    self._durations[name] = self._durations.get(
                        name, 0.0
                    ) + float(value[:-1])
                except ValueError:
                    pass
