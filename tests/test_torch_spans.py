"""Program spans (``core/timing.py``) on the CPU: off without a profiler,
nested per step under one, on the profiler's clock, and read by the
batched step's per-layer metrics."""

import gc
import importlib.util
import re
import statistics
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from image_transformation_tpu_torch.core import timing
from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.core.timing import StepTimer, reset_spans, span, span_summary
from image_transformation_tpu_torch.ops.compose_kernels import planarize_objects
from image_transformation_tpu_torch.parallel.sweep import make_solid_render_step, random_downscale_boxes

H, W, B = 160, 240, 2
STEP_SPANS = {"itx.step": None, "itx.render": "itx.step", "itx.render.meta": "itx.render",
              "itx.render.restore": "itx.render", "itx.render.compose": "itx.render",
              "itx.stat": "itx.step"}
METRICS = Path(__file__).resolve().parents[1] / "bench_torch" / "metrics"


@pytest.fixture(autouse=True)
def clean_spans():
    reset_spans()
    yield
    reset_spans()


def recording():
    """A CPU profiler, recording inside its ``with`` block."""
    return profile(activities=[ProfilerActivity.CPU])


def _raise(*args, **kwargs):
    raise AssertionError("called with no profiler recording")


def _reader(metric):
    """The ``read`` of the per-layer metric ``metric``, from its file."""
    spec = importlib.util.spec_from_file_location(metric, METRICS / f"{metric}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _step_and_sets(n_sets=3):
    """A reuse step on the CPU over squarespace's objects, and box sets."""
    arrays = load_bundle("data/squarespace").to_arrays()
    rng = np.random.default_rng(7)
    n = arrays.obj_hw.shape[0]
    hw = np.broadcast_to(arrays.obj_hw, (B, n, 2)).astype(np.int32)
    sets = [np.stack([random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(B)])
            for _ in range(n_sets)]
    static = tuple(tuple(int(v) for v in row) for row in arrays.obj_hw)
    step = make_solid_render_step((H, W), arrays.objects.shape[1:3], static_obj_hw=static,
                                  device="cpu")
    objs_p = planarize_objects(torch.from_numpy(arrays.objects[None]))
    return (lambda bx: step(None, objs_p, hw, bx)), sets


def test_step_without_a_profiler_opens_no_range_reads_no_clock_and_records_nothing(
        monkeypatch):
    assert not autograd_profiler._is_profiler_enabled
    run, sets = _step_and_sets()
    monkeypatch.setattr(timing, "record_function", _raise)
    monkeypatch.setattr(timing, "_Range", _raise)
    monkeypatch.setattr(timing, "_Span", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    monkeypatch.setattr(timing.time, "time_ns", _raise)
    for bx in sets:  # the fresh render, then reuse renders
        _, luma = run(bx)
    monkeypatch.undo()
    assert luma.shape == (B,)
    assert span_summary() == {"spans": {}, "records": []}


def test_reuse_step_spans_nest_and_share_one_step_id():
    run, sets = _step_and_sets()
    run(sets[0])  # the fresh render, outside the profiler
    with recording() as prof:
        run(sets[1])
        run(sets[2])
    records = span_summary()["records"]
    steps = sorted({r["step"] for r in records})
    assert len(steps) == 2 and steps[0] < steps[1]
    for sid in steps:
        mine = {r["name"]: r for r in records if r["step"] == sid}
        assert len([r for r in records if r["step"] == sid]) == len(STEP_SPANS)
        assert {n: r["parent"] for n, r in mine.items()} == STEP_SPANS
        for name, parent in STEP_SPANS.items():
            if parent is not None:
                assert mine[parent]["start_ns"] <= mine[name]["start_ns"]
                assert mine[name]["end_ns"] <= mine[parent]["end_ns"]
        assert mine["itx.render"]["end_ns"] <= mine["itx.stat"]["start_ns"]
        assert all(r["device_ms"] is None for r in mine.values())  # no device on the CPU
    names = {e.name for e in prof.events()}
    assert set(STEP_SPANS) <= names  # each span is a range of the profiler's timeline


def test_span_stamps_bracket_the_profiler_ranges():
    with recording() as prof:
        for _ in range(50):
            with span("itx.warm"):
                pass
        for _ in range(200):
            with span("itx.clock"):
                torch.zeros(4).add_(1)
    stamps = sorted((r["start_ns"], r["end_ns"]) for r in span_summary()["records"]
                    if r["name"] == "itx.clock")
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "itx.clock")
    assert len(stamps) == len(ranges) == 200
    lead = [a - t0 for (t0, _), (a, _) in zip(stamps, ranges)]
    lag = [t1 - b for (_, t1), (_, b) in zip(stamps, ranges)]
    assert min(lead) >= 0 and min(lag) >= 0
    assert statistics.median(lead) < 50_000 and statistics.median(lag) < 50_000


def test_launch_range_is_a_profiler_range_only_while_one_records():
    assert timing.launch_range("packed_luma") is timing._OFF
    with recording() as prof:
        with timing.launch_range("packed_luma"):
            torch.zeros(4).add_(1)
    assert "packed_luma" in {e.name for e in prof.events()}


def test_step_timer_without_a_profiler_keeps_its_echo_and_log(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(timing, "record_function", _raise)
    monkeypatch.setattr(timing, "_Range", _raise)
    timer = StepTimer()
    with timer.time_step("prepare"):
        pass
    with timer.time_step("prepare"):
        pass
    with timer.time_step("compose_baseline", echo=False):
        pass
    echo = capsys.readouterr().out.splitlines()
    assert len(echo) == 2 and all(re.fullmatch(r"\[TIME\] prepare: \d+\.\d{3}s", e)
                                  for e in echo)
    assert set(timer.summary()) == {"prepare", "compose_baseline"}
    path = tmp_path / "time_log.txt"
    timer.write_to_file(str(path))
    lines = path.read_text().splitlines()
    assert [line.split(": ")[0] for line in lines] == ["prepare", "compose_baseline"]
    assert all(re.fullmatch(r".+: \d+\.\d{3}s", line) for line in lines)
    assert span_summary()["records"] == []


def test_step_timer_under_a_profiler_is_a_span():
    timer = StepTimer()
    with recording() as prof:
        with timer.time_step("prepare", echo=False):
            with span("itx.inner"):
                pass
    spans = span_summary()["spans"]
    assert spans["prepare"]["count"] == 1 and spans["itx.inner"]["count"] == 1
    assert "prepare" in {e.name for e in prof.events()}
    assert spans["itx.inner"]["self_host_ms_p50"] <= spans["prepare"]["host_ms_p50"]


READERS = [("step.stat_device_ms", "itx.stat", "device_ms_p50"),
           ("step.render_device_ms", "itx.render", "device_ms_p50"),
           ("step.enqueue_ms", "itx.step", "host_ms_p50"),
           ("step.meta_host_ms", "itx.render.meta", "host_ms_p50")]


@pytest.mark.parametrize("metric, name, key", READERS)
def test_reader_is_none_without_records_and_reads_its_median(metric, name, key, monkeypatch):
    read = _reader(metric)
    assert read(None) is None
    entry = {"count": 3, "host_ms_p50": 1.25, "host_ms_p95": 2.0, "device_ms_p50": 7.125,
             "device_ms_p95": 7.5, "self_host_ms_p50": 0.5}
    fake = {"spans": {name: entry, "itx.other": dict(entry, host_ms_p50=9.0,
                                                     device_ms_p50=9.0)}, "records": []}
    monkeypatch.setattr(timing, "span_summary", lambda: fake)
    assert read(None) == entry[key]


def test_readers_on_a_cpu_step_give_host_times_and_no_device_time():
    run, sets = _step_and_sets(2)
    with recording():
        for bx in sets:
            run(bx)
    got = {m: _reader(m)(None) for m, _, _ in READERS}
    assert got["step.stat_device_ms"] is None and got["step.render_device_ms"] is None
    assert 0 < got["step.meta_host_ms"] < got["step.enqueue_ms"]


def test_self_time_is_duration_less_the_children_cover():
    with recording():
        with span("itx.parent"):
            time.sleep(0.002)
            with span("itx.child"):
                time.sleep(0.001)
                with span("itx.grandchild"):
                    time.sleep(0.001)
            with span("itx.child"):
                time.sleep(0.001)
    summary = span_summary()
    recs = {}
    for r in summary["records"]:
        recs.setdefault(r["name"], []).append(r)
    (parent,), children = recs["itx.parent"], recs["itx.child"]
    cover = sum(c["end_ns"] - c["start_ns"] for c in children)
    own = parent["end_ns"] - parent["start_ns"] - cover
    assert parent["child_ns"] == cover and own > 0
    assert summary["spans"]["itx.parent"]["self_host_ms_p50"] == own / 1e6
    g = recs["itx.grandchild"][0]
    first = min(children, key=lambda c: c["start_ns"])
    assert first["child_ns"] == g["end_ns"] - g["start_ns"]
    assert {r["parent"] for r in children} == {"itx.parent"}
    assert len({r["step"] for r in summary["records"]}) == 1


def test_records_are_bounded_oldest_first_and_counts_kept(monkeypatch):
    monkeypatch.setattr(timing, "SPAN_RECORDS", 5)
    with recording():
        for _ in range(8):  # eight steps of one span each
            with span("itx.a"):
                pass
    summary = span_summary()
    assert summary["spans"]["itx.a"]["count"] == 8
    steps = [r["step"] for r in summary["records"]]
    assert steps == list(range(steps[-1] - 4, steps[-1] + 1))  # the newest five


def test_closed_spans_leave_no_object_for_the_collector():
    """A long trace must not bring the collector's full collections sooner."""
    with recording():
        for _ in range(10):
            with span("itx.a"):
                pass
        gc.disable()
        try:
            before = gc.get_count()[0]
            for _ in range(500):
                with span("itx.a"):
                    with span("itx.b"):
                        pass
            grown = gc.get_count()[0] - before
        finally:
            gc.enable()
    assert grown < 10
    assert span_summary()["spans"]["itx.b"]["count"] == 500
