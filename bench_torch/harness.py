"""The harness: finds a cell's configuration, traffic mix, driver and
metric readers by name, runs set-up, the measured window and the check, and
assembles the result line.

Everything that belongs to one configuration, mix, driver or metric is a
file of its own:

* ``BENCHMARK.json`` (the checkout's root): cells, metrics, ``run_seconds``;
* ``configs/<config>.json``: a deployment (bundle, canvas policy, backgrounds);
* ``mixes/<traffic>.json``: the traffic, with the driver it uses;
* ``drivers/<driver>.py``: one per kind of entry point, a ``Driver`` class;
* ``metrics/<metric>.py``: one reader per per-layer metric, ``read(ctx)``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def load_json(path: Path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _module(path: Path):
    """Import a harness file by path (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(f"bench_torch_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_cell(name: str, benchmark: Optional[Dict] = None, pending: bool = False) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its configuration, mix and
    metrics; with ``pending`` also one of ``pending_cells.json`` (cells built
    and tested but not yet in the benchmark)."""
    bench = benchmark or load_json(CHECKOUT / "BENCHMARK.json")
    if pending:
        extra = load_json(HERE / "pending_cells.json")
        bench = {k: bench[k] + extra[k] for k in ("configs", "workloads", "end_to_end",
                                                  "per_layer")}
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(CHECKOUT / cfg["file"])
    mix = load_json(HERE / "mixes" / f"{w['traffic']}.json")

    def mine(metric):
        return name in metric.get("workloads", [name])

    return Cell(name, int(w["chips"]), config, mix,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


class Spans:
    """The harness's spans: (name, start s, end s) on the host clock, kept in
    memory; with ``trace`` each is also a profiler range ``bench.<name>``."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.records: List[tuple] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = None
        if self.trace:
            from torch.profiler import record_function

            rf = record_function("bench." + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.records.append((name, t0, t1))

    def durations_ms(self, name: str) -> List[float]:
        return [(b - a) * 1e3 for n, a, b in self.records if n == name]


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's default)."""
    s = sorted(values)
    if not s:
        raise ValueError("no samples")
    r = (len(s) - 1) * q / 100.0
    lo = int(r)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (r - lo)


def median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None


@dataclass
class Check:
    """One number compared with the reference, beside its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Context:
    """What a driver and the metric readers see."""

    cell: Cell
    seed: int
    device: str
    spans: Spans
    trace: bool
    overrides: Dict = field(default_factory=dict)
    counters: Dict = field(default_factory=dict)
    trace_summary: Optional[Dict] = None
    device_name: str = "cpu"

    def param(self, key: str):
        """A mix parameter, or its override (CPU tests shrink sizes)."""
        return self.overrides.get(key, self.cell.mix[key])


def load_driver(ctx: Context):
    return importlib.import_module(f"bench_torch.drivers.{ctx.cell.mix['driver']}").Driver(ctx)


def read_per_layer(ctx: Context) -> Dict[str, Dict]:
    out = {}
    for m in ctx.cell.per_layer:
        value = _module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: Optional[Dict] = None, patch: Optional[Callable] = None,
             precision: str = "exact") -> Dict:
    """One run: set-up (timed as ``setup_s``), the window of ``seconds``, and
    the check. ``patch(driver)`` may replace the driver's timed path (the
    harness's own fault tests); ``precision`` other than "exact" puts the
    reference at that precision in the program's place (the control)."""
    import torch

    t0 = time.perf_counter()
    ctx = Context(cell, int(seed), device, Spans(trace), trace, dict(overrides or {}))
    if device.startswith("cuda"):
        ctx.device_name = torch.cuda.get_device_name()
    driver = load_driver(ctx)
    if patch is not None:
        patch(driver)
    driver.setup()
    _sync(device)
    setup_s = time.perf_counter() - t0
    # the harness's own set-up objects (layout pools, box sets) are kept out
    # of the collector's scans, so its full collections in the window cost
    # what the program's own objects cost
    gc.collect()
    gc.freeze()

    prof = None
    remote = getattr(driver, "remote_trace", False)  # the driver traces its own process
    if trace and not remote:
        from . import trace as tracing

        prof = tracing.profiler()
        prof.start()
    with ctx.spans("window"):
        e2e = driver.window(seconds)
        _sync(device)
    gc.unfreeze()
    if prof is not None:
        prof.stop()
        ctx.trace_summary = tracing.reduce(tracing.raw_events(prof))
        del prof
    elif trace:
        ctx.trace_summary = driver.trace_summary
    memory_peak = driver.memory_peak_bytes() if device.startswith("cuda") else 0
    layer = read_per_layer(ctx) if trace else {}
    driver.release()
    checks = driver.check(precision)
    attempted, failed = driver.attempted, driver.failed
    correct = failed == 0 and bool(checks) and all(c.ok for c in checks)

    if trace:
        metrics = layer
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        e2e = dict(e2e, setup_s=setup_s)
        metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items() if k in units}
    device_info = {"platform": "gpu" if device.startswith("cuda") else "cpu",
                   "kind": ctx.device_name, "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace and ctx.trace_summary is not None:
        device_info["busy_s"] = ctx.trace_summary["busy_s"]
        device_info["window_s"] = ctx.trace_summary["window_s"]
        result["breakdown"] = {k: ctx.trace_summary[k] for k in ("device_ops", "idle_gaps")}
        result["_spans"] = ctx.trace_summary["spans"]  # printed by report(), not in the line
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


def report(result: Dict, stream_out=None, stream_err=None) -> None:
    """Print each compared number beside its limit as the last lines of
    standard error, and the result as the last line of standard output."""
    stream_out = stream_out or sys.stdout
    stream_err = stream_err or sys.stderr
    for name, entry in sorted(result.pop("_spans", {}).items()):
        print(f"trace span {name}: device {entry['device_s']!r} s, {entry['launches']} launches",
              file=stream_err)
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} {verdict}", file=stream_err)
    stream_err.flush()
    print(json.dumps(result), file=stream_out)
    stream_out.flush()
