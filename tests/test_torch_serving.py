"""The port's serving daemon on the CPU (the plain versions of K1 and K2)
against the JAX package's ComposeService on its CPU backend, and the
daemon's host machinery: coalescing, dedupe, the wedge deadline, the idle
floor refresh, the K2 failure path and the HTTP endpoints.

Tolerances: /v1/render pixels 0 (vs JAX and vs PIL), solved boxes equal;
/v1/render_batch canvases within 2/255 of JAX, whose CPU backend runs its
XLA step there (the traced-table envelope). Concurrency is driven with
``threading.Event`` gates, not sleeps.
"""

import base64
import concurrent.futures
import io
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from image_transformation_tpu.serving import ComposeService as JaxService
from image_transformation_tpu_torch.pipeline import fused as port_fused
from image_transformation_tpu_torch.serving import ComposeService, serve
from image_transformation_tpu_torch.serving import server as srv

ROOT = Path(__file__).resolve().parents[1]
LABELS = {"squarespace": [(1, "logo"), (2, "photo"), (3, "text"), (4, "cta")],
          "audio_book": [(1, "logo"), (2, "photo"), (3, "text")]}
#: bounded waits of the gated tests (s); none is reached when they pass
WAIT_S = 60.0


@pytest.fixture(scope="module")
def port_svc(tmp_path_factory):
    return ComposeService("data", tmp_path_factory.mktemp("port") / "steps.json", device="cpu")


@pytest.fixture(scope="module")
def jax_svc(tmp_path_factory):
    return JaxService("data", manifest_path=tmp_path_factory.mktemp("jax") / "steps.json")


def _new_service(tmp_path) -> ComposeService:
    return ComposeService("data", manifest_path=tmp_path / "steps.json", device="cpu")


def _random_layout(rng, bundle):
    """A column or row of a random subset of the bundle's objects in random
    order, with a random gap, sometimes one nested container."""
    items = LABELS[bundle]
    chosen = [items[i] for i in rng.permutation(len(items))[: rng.integers(1, len(items) + 1)]]
    children = [{"object_id": oid, "name": name} for oid, name in chosen]
    if len(children) >= 2 and rng.random() < 0.4:
        children = [children[0], {"type": "flex",
                                  "direction": str(rng.choice(["row", "column"])),
                                  "children": children[1:]}]
    return {"root": {"type": "flex", "direction": str(rng.choice(["row", "column"])),
                     "gap_px": int(rng.integers(0, 40)), "children": children}}


def _pil_render(svc, stem, canvas_size, background, placements):
    """PIL's own compose on the service's canvas: LANCZOS resize +
    alpha_composite in list order."""
    bundle = svc._bundle(stem)
    canvas = Image.fromarray(svc._canvas(bundle, canvas_size, background).cpu().numpy(), "RGBA")
    for p in placements:
        x1, y1, x2, y2 = (int(v) for v in p["box"])
        obj = bundle.objects[int(p["object_id"])]
        canvas.alpha_composite(obj.resize((max(1, x2 - x1), max(1, y2 - y1)), Image.LANCZOS),
                               dest=(x1, y1))
    return np.asarray(canvas)


def _wait_until(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def _worker_retired(coal):
    with coal._lock:
        return coal._worker is None


def _join_drain_workers():
    """Wait for every coalescer worker to retire (after its idle floor and
    calibration pass): a daemon thread still inside torch when the
    interpreter exits aborts the process."""
    for t in threading.enumerate():
        if t.name == "coalescer-drain":
            t.join(WAIT_S)
            assert not t.is_alive(), "a drain worker did not retire"


@pytest.fixture(autouse=True)
def _drain_workers_retire():
    yield
    _join_drain_workers()


@pytest.fixture(scope="module", autouse=True)
def _no_idle_background_work():
    """Neither daemon's idle device calibration nor JAX's merge-bucket warm
    thread is under test here, except where a test turns the calibration
    back on: both only burn CPU that other test processes share."""
    import image_transformation_tpu.serving.server as jax_srv

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(srv, "_CALIB_TTL_S", float("inf"))
        mp.setattr(jax_srv, "_CALIB_TTL_S", float("inf"))
        mp.setattr(jax_srv.ComposeService, "_warm_merge_buckets",
                   staticmethod(lambda engine: None))
        yield


# ---------------------------------------------------------------- parity


@pytest.mark.parametrize("stem,ratio,background,seed", [
    ("squarespace", "9:16", "solid", None),
    ("squarespace", "1:1", "gradient", 1),
    ("squarespace", "16:9", "solid", 2),
    ("squarespace", "4:1", "gradient", 3),
    ("audio_book", "9:16", "gradient", None),
    ("audio_book", "1:1", "solid", 4),
    ("audio_book", "16:9", "gradient", 5),
    ("audio_book", "4:1", "solid", 6),
])
def test_render_equals_jax_and_pil(port_svc, jax_svc, stem, ratio, background, seed):
    layout = None if seed is None else _random_layout(np.random.default_rng(seed), stem)
    placements, canvas_size, got = port_svc.render(stem, ratio, layout, background)
    j_place, j_size, want = jax_svc.render(stem, ratio, layout, background)
    assert (placements, canvas_size) == (j_place, j_size)
    assert got.dtype == np.uint8 and got.shape == (canvas_size[1], canvas_size[0], 4)
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, _pil_render(port_svc, stem, canvas_size, background, placements))


@pytest.mark.parametrize("seed", range(4))
def test_boxes_only_placements_equal_jax(port_svc, jax_svc, seed):
    rng = np.random.default_rng(100 + seed)
    stem = str(rng.choice(list(LABELS)))
    ratio = str(rng.choice(["9:16", "1:1", "16:9", "4:1", "3:2"]))
    layout = _random_layout(rng, stem)
    assert port_svc.solve(stem, ratio, layout) == jax_svc.solve(stem, ratio, layout)


@pytest.mark.parametrize("stem,background", [("squarespace", "solid"), ("audio_book", "gradient")])
def test_render_batch_equals_jax_and_pil(port_svc, jax_svc, stem, background):
    ratios = ["9:16", "1:1", "16:9", "4:1"]
    got = port_svc.render_batch(stem, ratios, background=background)
    want = jax_svc.render_batch(stem, ratios, background=background)
    assert list(got) == ratios
    for r in ratios:
        (w, h), boxes, img = got[r]
        assert (w, h) == tuple(want[r][0]) and boxes == want[r][1]
        assert img.shape == (h, w, 4)
        jax_err = np.abs(img.astype(int) - np.asarray(want[r][2]).astype(int)).max()
        assert jax_err <= 2, (r, jax_err)
        placements = [{"object_id": oid, "box": b} for (oid, _), b in zip(LABELS[stem], boxes)]
        pil = _pil_render(port_svc, stem, (w, h), background, placements)
        assert np.abs(img.astype(int) - pil.astype(int)).max() <= 2, r


def test_render_timings_and_stats_keys_equal_jax(port_svc, jax_svc):
    _, _, _, t_port = port_svc.render_timed("squarespace", "1:1")
    _, _, _, t_jax = jax_svc.render_timed("squarespace", "1:1")
    own = {"_png_share", "calibration_age_s"}  # present once calibrated
    assert set(t_port) - own == set(t_jax) - own
    s_port, s_jax = port_svc.stats(), jax_svc.stats()
    assert set(s_port) == set(s_jax)
    assert set(s_port["latency_ms"]) == set(s_jax["latency_ms"])
    assert set(s_port["dispatch_floor"]) == set(s_jax["dispatch_floor"])
    assert s_port["batch_latched"] is False


# ---------------------------------------------------------------- engine


def test_compose_many_equals_sequential_with_ragged_lists(port_svc):
    full, canvas_size = port_svc.solve("squarespace", "1:1")
    engine = port_svc._engine("squarespace", canvas_size, "solid")
    sets = [full, full[:2], [{"object_id": 99, "box": [0, 0, 5, 5]}], full[1:3], full[::-1]]
    stacked = engine.compose_many(sets)
    assert stacked.shape == (len(sets), canvas_size[1], canvas_size[0], 4)
    for i, ps in enumerate(sets):
        assert torch.equal(stacked[i], engine.compose(ps)), i
    # the merge's tables are cached under JAX's signature, padded to 4 rows
    assert any(sig[:2] == ("many", 4) for sig in engine._call_cache)


def test_engine_call_cache_lru_bounds_bytes(tmp_path):
    svc = _new_service(tmp_path)
    full, canvas_size = svc.solve("squarespace", "1:1")
    engine = svc._engine("squarespace", canvas_size, "solid")
    assert engine._cache_bytes == 0
    engine.compose(full)
    one_sig = engine._cache_bytes
    assert one_sig > 0
    engine._cache_max_bytes = one_sig + one_sig // 2
    for i in range(1, 6):
        engine.compose([{**p, "box": [v + i for v in p["box"]]} for p in full])
    assert engine._cache_bytes <= engine._cache_max_bytes
    assert len(engine._call_cache) < 6  # evictions happened
    n, nbytes = len(engine._call_cache), engine._cache_bytes
    engine.compose([{**p, "box": [v + 5 for v in p["box"]]} for p in full])  # a hit
    assert (len(engine._call_cache), engine._cache_bytes) == (n, nbytes)


def test_engine_cache_holds_its_byte_count_under_thread_stress(tmp_path):
    """16 threads compose and merge on one engine with a byte budget that
    forces evictions: the cache's byte count stays the sum of its entries
    (a lost update under the lock would break it) and every result equals
    the sequential one."""
    svc = _new_service(tmp_path)
    full, canvas_size = svc.solve("squarespace", "1:1")
    engine = svc._engine("squarespace", canvas_size, "solid")
    sets = [[{**p, "box": [v + i for v in p["box"]]} for p in full] for i in range(6)]
    want = [engine.compose(ps) for ps in sets]
    engine._cache_max_bytes = 2 * engine._cache_bytes // len(sets)

    def work(t):
        i = t % len(sets)
        if t % 3 == 0:
            out = engine.compose_many([sets[i], sets[(i + 1) % len(sets)]])
            return torch.equal(out[0], want[i]) and torch.equal(
                out[1], want[(i + 1) % len(sets)])
        return torch.equal(engine.compose(sets[i]), want[i])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=16) as pool:
            results = list(pool.map(work, range(96), timeout=WAIT_S))
    finally:
        sys.setswitchinterval(old)
    assert all(results)
    assert engine._cache_bytes == sum(nb for _, nb in engine._call_cache.values())
    assert engine._cache_bytes <= engine._cache_max_bytes or len(engine._call_cache) == 1


def test_measure_device_ms_runs_the_merge_program(port_svc):
    full, canvas_size = port_svc.solve("squarespace", "1:1")
    engine = port_svc._engine("squarespace", canvas_size, "solid")
    assert engine.measure_device_ms([full], reps=2) > 0.0
    assert engine.measure_device_ms([full, full[:1]], reps=2) > 0.0
    assert engine.measure_device_ms([full], reps=2, floor_ms=1e9) == 0.0


# ------------------------------------------------------------ coalescing


def _gate_first_compose(monkeypatch, engine):
    """Make the engine's next compose() wait on a gate; returns (entered,
    gate) events."""
    entered, gate = threading.Event(), threading.Event()
    real = engine.compose

    def gated(placements):
        if not entered.is_set():
            entered.set()
            assert gate.wait(WAIT_S)
        return real(placements)

    monkeypatch.setattr(engine, "compose", gated)
    return entered, gate


def test_concurrent_renders_merge_and_dedupe(monkeypatch, tmp_path):
    svc = _new_service(tmp_path)
    base, canvas_size = svc.solve("squarespace", "1:1")
    coal = svc._coalescer("squarespace", canvas_size, "solid")
    variants = [[{**p, "box": [v + i for v in p["box"]]} for p in base] for i in range(4)]
    expected = [coal.engine.compose(v).numpy() for v in variants]
    many_calls = []
    real_many = coal.engine.compose_many
    monkeypatch.setattr(coal.engine, "compose_many",
                        lambda sets: many_calls.append(len(sets)) or real_many(sets))
    entered, gate = _gate_first_compose(monkeypatch, coal.engine)
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        futs = [pool.submit(coal.render, variants[0])]
        assert entered.wait(WAIT_S)  # the first merge is in flight
        later = variants[1:] * 2  # three unique sets, each twice
        futs += [pool.submit(coal.render, v) for v in later]
        _wait_until(lambda: len(coal._pending) == len(later), "the queue to fill")
        gate.set()
        outs = [f.result(WAIT_S) for f in futs]
    assert svc.coalescing_stats() == {"requests": 7, "dispatches": 2, "deduped": 3}
    assert many_calls == [4]  # three unique sets padded to a merge of 4
    for out, want in zip(outs, [expected[0]] + [expected[i] for i in (1, 2, 3) * 2]):
        assert np.array_equal(out, want)


def test_identical_requests_dedupe_to_one_compose_leg(monkeypatch, tmp_path):
    svc = _new_service(tmp_path)
    placements, canvas_size = svc.solve("squarespace", "1:1")
    coal = svc._coalescer("squarespace", canvas_size, "solid")
    many_calls = []
    monkeypatch.setattr(coal.engine, "compose_many", lambda sets: many_calls.append(sets))
    entered, gate = _gate_first_compose(monkeypatch, coal.engine)
    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as pool:
        futs = [pool.submit(coal.render, placements)]
        assert entered.wait(WAIT_S)
        futs += [pool.submit(coal.render, placements) for _ in range(5)]
        _wait_until(lambda: len(coal._pending) == 5, "the queue to fill")
        gate.set()
        outs = [f.result(WAIT_S) for f in futs]
    stats = svc.coalescing_stats()
    assert stats["deduped"] == 4 and stats["dispatches"] == 2, stats
    assert many_calls == []  # identical sets never took the merged path
    for out in outs[1:]:
        assert np.array_equal(out, outs[0])


def test_placements_key_ignores_dict_order():
    a = [{"object_id": 1, "box": [0, 0, 4, 4], "scale": 1.0}]
    b = [{"scale": 1.0, "box": [0, 0, 4, 4], "object_id": 1}]
    c = [{"object_id": 1, "box": [0, 0, 4, 5], "scale": 1.0}]
    assert srv._Coalescer._placements_key(a) == srv._Coalescer._placements_key(b)
    assert srv._Coalescer._placements_key(a) != srv._Coalescer._placements_key(c)


def test_bad_placement_fails_alone_in_a_merge(monkeypatch, tmp_path):
    svc = _new_service(tmp_path)
    placements, canvas_size = svc.solve("squarespace", "1:1")
    coal = svc._coalescer("squarespace", canvas_size, "solid")
    want = coal.engine.compose(placements).numpy()
    bad = [{"object_id": 1, "box": [0, 0, 4000, 4000]}]  # past the envelope
    entered, gate = _gate_first_compose(monkeypatch, coal.engine)
    with concurrent.futures.ThreadPoolExecutor(max_workers=3) as pool:
        first = pool.submit(coal.render, placements)
        assert entered.wait(WAIT_S)
        futs = [pool.submit(coal.render, bad), pool.submit(coal.render, placements)]
        _wait_until(lambda: len(coal._pending) == 2, "the queue to fill")
        gate.set()
        assert np.array_equal(first.result(WAIT_S), want)
        with pytest.raises(ValueError, match="envelope"):
            futs[0].result(WAIT_S)
        assert np.array_equal(futs[1].result(WAIT_S), want)


def test_rgb_readback_off_matches_on(monkeypatch, port_svc):
    placements, canvas_size = port_svc.solve("squarespace", "1:1")
    coal = port_svc._coalescer("squarespace", canvas_size, "solid")
    assert coal.engine.opaque_output
    on = coal.render(placements)
    assert on.shape[-1] == 4 and bool((on[..., 3] == 255).all())
    monkeypatch.setattr(srv, "_RGB_READBACK", False)
    assert np.array_equal(on, coal.render(placements))


def test_render_stuck_error_frees_caller_and_flags_backlog(monkeypatch, tmp_path):
    svc = _new_service(tmp_path)
    placements, canvas_size = svc.solve("squarespace", "1:1")
    coal = svc._coalescer("squarespace", canvas_size, "solid")
    baseline = coal.render(placements)
    wedge = threading.Event()
    real = coal.engine.compose
    monkeypatch.setattr(coal.engine, "compose",
                        lambda p: wedge.wait(WAIT_S) and real(p))
    monkeypatch.setattr(srv, "_RENDER_WAIT_S", 0.5)
    with pytest.raises(srv.RenderStuckError, match="queue depth"):
        coal.render(placements)
    # the stuck ticket left the queue inside the wedged merge: the backlog
    # signal counts unfinished merges
    assert svc.backlog_age_s() > 0.4
    wedge.set()
    monkeypatch.setattr(coal.engine, "compose", real)
    monkeypatch.setattr(srv, "_RENDER_WAIT_S", WAIT_S)
    _wait_until(lambda: coal.backlog_age_s() == 0.0, "the wedged merge to settle")
    assert np.array_equal(coal.render(placements), baseline)


def test_idle_calibration_publishes_device_ms(monkeypatch, tmp_path):
    """At idle the worker calibrates the merge program it served (JAX's
    amortized protocol); later renders publish that as device_ms, with the
    single-shot residual beside it."""
    monkeypatch.setattr(srv, "_CALIB_TTL_S", 120.0)
    svc = _new_service(tmp_path)
    placements, canvas_size = svc.solve("squarespace", "1:1")
    coal = svc._coalescer("squarespace", canvas_size, "solid")
    _, first = coal.render_timed(placements)
    assert first["device_source"] == "residual"
    assert first["device_ms"] == first["device_residual_ms"]
    _wait_until(lambda: _worker_retired(coal), "the calibration to end")
    info = coal.calibration_info()["singlex1"]
    assert info["device_ms"] > 0.0 and info["reps"] >= srv._CALIB_REPS_MIN
    assert not info["failed"]
    _, timings = coal.render_timed(placements)
    assert timings["device_source"] == "calibrated"
    assert timings["device_ms"] == info["device_ms"] and timings["calibration_age_s"] >= 0.0
    assert any("singlex1" in v for v in svc.stats()["device_calibration"].values())


# ------------------------------------------------------ the dispatch floor


def test_floor_refreshes_when_stale_at_idle(tmp_path):
    svc = _new_service(tmp_path)
    placements, canvas_size = svc.solve("squarespace", "1:1")
    coal = svc._coalescer("squarespace", canvas_size, "solid")
    coal.render(placements)  # calibrates the floor on the first dispatch
    _wait_until(lambda: _worker_retired(coal), "the worker to retire")
    svc.floor._floor_ms = 12345.0
    svc.floor._age -= 2 * srv._DISPATCH_FLOOR_TTL_S
    assert svc.floor.stale()
    coal.render(placements)
    _wait_until(lambda: _worker_retired(coal), "the worker to retire")
    assert svc.floor.info()["floor_ms"] != 12345.0 and not svc.floor.stale()


def test_floor_refresh_failure_never_strands_worker(monkeypatch, tmp_path):
    svc = _new_service(tmp_path)
    placements, canvas_size = svc.solve("squarespace", "1:1")
    coal = svc._coalescer("squarespace", canvas_size, "solid")
    out = coal.render(placements)
    _wait_until(lambda: _worker_retired(coal), "the worker to retire")
    floor_before = svc.floor.info()["floor_ms"]

    def boom(device, n=5):
        raise RuntimeError("device wedged")

    monkeypatch.setattr(srv, "_measure_floor_samples", boom)
    svc.floor._age -= 2 * srv._DISPATCH_FLOOR_TTL_S
    coal.render(placements)
    _wait_until(lambda: _worker_retired(coal), "the worker to retire")
    assert svc.floor.info()["floor_ms"] == floor_before  # the old floor is kept
    assert not svc.floor.stale()  # age bumped: not retried hot
    assert np.array_equal(coal.render(placements), out)


def test_idle_workers_do_not_spin_on_a_refresh_in_flight(monkeypatch, tmp_path):
    """Two idle coalescers find the floor stale while one slow refresh is
    in flight: the measurement runs once, and the other worker retires
    instead of asking again in a loop (JAX's server returns the stale
    floor at once there, and its drain loops hot until the refresh ends)."""
    svc = _new_service(tmp_path)
    coals = []
    for ratio in ("1:1", "9:16"):
        placements, canvas_size = svc.solve("squarespace", ratio)
        coal = svc._coalescer("squarespace", canvas_size, "solid")
        coal.render(placements)
        coals.append((coal, placements))
    for coal, _ in coals:  # first floor and calibrations done
        _wait_until(lambda: _worker_retired(coal), "the worker to retire")

    measured, gate = [], threading.Event()

    def slow_measure(device, n=5):
        measured.append(device)
        assert gate.wait(WAIT_S)
        return [0.25] * n

    refreshes = []
    real_get = svc.floor.get

    def counting_get(refresh=False):
        if refresh:
            refreshes.append(threading.current_thread().name)
        return real_get(refresh)

    monkeypatch.setattr(srv, "_measure_floor_samples", slow_measure)
    monkeypatch.setattr(svc.floor, "get", counting_get)
    svc.floor._age -= 2 * srv._DISPATCH_FLOOR_TTL_S
    (first, p1), (second, p2) = coals
    first.render(p1)
    _wait_until(lambda: len(measured) == 1, "the slow refresh to start")
    second.render(p2)  # served on the old floor while the refresh runs
    _wait_until(lambda: _worker_retired(second), "the second worker to retire")
    assert not _worker_retired(first)  # still inside the refresh
    assert len(refreshes) == 1 and len(measured) == 1
    gate.set()
    _wait_until(lambda: _worker_retired(first), "the refreshing worker to retire")
    assert len(refreshes) == 1 and len(measured) == 1
    assert svc.floor.info()["floor_ms"] == 0.25 and not svc.floor.stale()


def test_floor_waiter_is_bounded_while_another_refreshes(monkeypatch, tmp_path):
    """A thread that asks for a refresh while another runs one waits for
    it, bounded, and never measures a second time."""
    floor = srv.DispatchFloor(torch.device("cpu"))
    assert floor.get() > 0.0
    gate, measured = threading.Event(), []

    def slow_measure(device, n=5):
        measured.append(1)
        assert gate.wait(WAIT_S)
        return [0.5] * n

    monkeypatch.setattr(srv, "_measure_floor_samples", slow_measure)
    monkeypatch.setattr(srv, "_FLOOR_WAIT_S", 0.05)
    floor._age -= 2 * srv._DISPATCH_FLOOR_TTL_S
    refresher = threading.Thread(target=floor.get, kwargs={"refresh": True})
    refresher.start()
    _wait_until(lambda: measured, "the refresh to start")
    assert not floor.stale()  # a refresh in flight is not stale
    floor.get(refresh=True)  # returns after a bounded wait, no second measure
    assert len(measured) == 1
    gate.set()
    refresher.join(WAIT_S)
    assert not refresher.is_alive() and floor.info()["floor_ms"] == 0.5


# ------------------------------------------------------------ render_batch


def test_k2_failure_raises_and_latches_nothing(monkeypatch, tmp_path):
    svc = _new_service(tmp_path)
    with pytest.raises(Exception):
        svc.render_batch("squarespace", ["not-a-ratio"])
    with pytest.raises(ValueError):
        svc.render_batch("squarespace", ["1:1"], layout={"notroot": {}})
    calls = []

    def failing_k2(*args, **kwargs):
        calls.append(1)
        raise RuntimeError("fused_v3: kernel launch failed with CUDA error 700")

    monkeypatch.setattr(port_fused, "fused_v3", failing_k2)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        svc.render_batch("squarespace", ["1:1", "9:16"])
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        svc.render_batch("squarespace", ["1:1", "9:16"])  # K2 again, no latch
    assert len(calls) == 2 and svc.stats()["batch_latched"] is False
    monkeypatch.undo()
    out = svc.render_batch("squarespace", ["9:16", "1:1"])
    assert set(out) == {"9:16", "1:1"} and len(svc._batch_steps) == 1


def test_render_batch_iter_and_ratio_order_share_the_step(port_svc):
    ratios = ["9:16", "1:1", "9:16"]
    entries = list(port_svc.render_batch_iter("squarespace", ratios))
    assert [r for r, _ in entries] == ["9:16", "1:1"]
    buffered = port_svc.render_batch("squarespace", ["1:1", "9:16"])
    for r, ((w, h), boxes, img) in entries:
        assert img.shape == (h, w, 4)
        assert buffered[r][0] == (w, h) and buffered[r][1] == boxes
        assert np.array_equal(img, buffered[r][2])
    key_count = sum(1 for k in port_svc._batch_steps if k[0] == "squarespace"
                    and k[2] == ("1:1", "9:16"))
    assert key_count == 1
    with pytest.raises(FileNotFoundError):
        port_svc.render_batch_iter("no-such-bundle", ["1:1"])


def test_warm_start_rebuilds_recorded_steps(tmp_path):
    manifest = tmp_path / "steps.json"
    first = ComposeService("data", manifest, device="cpu").render_batch(
        "squarespace", ["1:1", "9:16"])
    assert manifest.exists()
    svc2 = ComposeService("data", manifest, device="cpu")
    assert svc2.warm_start() == 1 and len(svc2._batch_steps) == 1
    again = svc2.render_batch("squarespace", ["9:16", "1:1"])
    for ratio in ("1:1", "9:16"):
        assert np.array_equal(first[ratio][2], again[ratio][2])


def test_default_manifest_is_the_ports_own():
    svc = ComposeService("data", device="cpu")
    assert svc.manifest_path.parts[-3:] == (
        ".cache", "image_transformation_tpu_torch", "serving_steps.json")


# -------------------------------------------------------------------- HTTP


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    daemon = serve("data", port=0, device="cpu")
    daemon.service.manifest_path = tmp_path_factory.mktemp("http") / "steps.json"
    thread = threading.Thread(target=daemon.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{daemon.server_address[1]}", daemon.service
    daemon.shutdown()
    daemon.server_close()
    thread.join(timeout=WAIT_S)
    assert not thread.is_alive()


def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def test_http_healthz_and_bundles(server):
    base, _ = server
    with urllib.request.urlopen(base + "/healthz") as r:
        health = json.loads(r.read())
    assert health == {"ok": True, "device": "cpu", "bundles": 2, "backlog_age_s": 0.0}
    with urllib.request.urlopen(base + "/v1/bundles") as r:
        bundles = json.loads(r.read())
    assert {b["stem"] for b in bundles} == {"squarespace", "audio_book"}
    assert all(b["original"] == [970, 250] for b in bundles)


def test_http_render_png_and_raw(server, jax_svc):
    base, service = server
    status, png, headers = _post(base, "/v1/render", {"bundle": "squarespace", "ratio": "9:16"})
    assert status == 200 and headers["Content-Type"] == "image/png"
    img = np.asarray(Image.open(io.BytesIO(png)).convert("RGBA"))
    timings = json.loads(headers["X-Render-Timings"])
    assert timings["encode_ms"] >= 0 and timings["merged"] >= 1
    status, raw, headers = _post(base, "/v1/render",
                                 {"bundle": "squarespace", "ratio": "9:16", "format": "raw"})
    assert status == 200 and headers["Content-Type"] == "application/octet-stream"
    shape = tuple(int(v) for v in headers["X-Raw-Shape"].split(","))
    assert shape == (657, 369, 4)
    assert np.array_equal(np.frombuffer(raw, np.uint8).reshape(shape), img)
    assert np.array_equal(img, np.asarray(jax_svc.render("squarespace", "9:16")[2]))
    status, body, _ = _post(base, "/v1/render", {"bundle": "squarespace", "ratio": "1:1",
                                                 "boxes_only": True})
    assert status == 200 and json.loads(body)["canvas"] == {"width": 492, "height": 492}
    assert service.stats()["requests"] >= 2


def test_http_errors(server):
    base, _ = server
    assert _post(base, "/v1/render", {"ratio": "1:1"})[0] == 400
    assert _post(base, "/v1/render", {"bundle": "nope", "ratio": "1:1"})[0] in (404, 500)
    status, body, _ = _post(base, "/v1/render", {"bundle": "squarespace", "ratio": "1:1",
                                                 "layout": {"type": "flex"}})
    assert status == 500 and b"root" in body
    assert _post(base, "/v1/render_batch", {"ratios": ["1:1"]})[0] == 400
    assert _post(base, "/v1/nope", {})[0] == 404


def test_http_k2_failure_is_a_500_and_not_latched(monkeypatch, server):
    base, service = server
    monkeypatch.setattr(port_fused, "fused_v3",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("K2 failed")))
    payload = {"bundle": "audio_book", "ratios": ["1:1", "21:9"]}
    status, body, _ = _post(base, "/v1/render_batch", payload)
    assert status == 500 and b"K2 failed" in body
    monkeypatch.undo()
    status, body, _ = _post(base, "/v1/render_batch", payload)
    assert status == 200 and set(json.loads(body)) == {"1:1", "21:9"}
    assert service.stats()["batch_latched"] is False


def test_http_render_batch_stream_equals_buffered(server):
    base, _ = server
    status, body, headers = _post(base, "/v1/render_batch", {
        "bundle": "squarespace", "ratios": ["1:1", "9:16"], "stream": True})
    assert status == 200 and "ndjson" in headers["Content-Type"]
    lines = [json.loads(ln) for ln in body.decode().splitlines() if ln]
    assert [ln["ratio"] for ln in lines] == ["1:1", "9:16"]
    status, buffered, _ = _post(base, "/v1/render_batch",
                                {"bundle": "squarespace", "ratios": ["1:1", "9:16"]})
    buffered = json.loads(buffered)
    for ln in lines:
        assert ln == {"ratio": ln["ratio"], **buffered[ln["ratio"]]}
        img = Image.open(io.BytesIO(base64.b64decode(ln["png_b64"])))
        assert img.size == (ln["canvas"]["width"], ln["canvas"]["height"])


def test_http_render_fleet_buffered_and_streamed(server):
    base, _ = server
    status, body, _ = _post(base, "/v1/render_fleet", {"ratios": ["1:1", "9:16"]})
    assert status == 200
    payload = json.loads(body)
    assert set(payload) == {"squarespace", "audio_book"}
    status, body, _ = _post(base, "/v1/render_batch", {"bundle": "squarespace",
                                                       "ratios": ["1:1", "9:16"]})
    assert payload["squarespace"] == json.loads(body)
    status, body, headers = _post(base, "/v1/render_fleet", {
        "bundles": ["squarespace", "no_such_bundle"], "ratios": ["1:1"], "stream": True})
    assert status == 200 and "ndjson" in headers["Content-Type"]
    by_stem = {ln["bundle"]: ln for ln in map(json.loads, body.decode().splitlines()) if ln}
    assert "error" in by_stem["no_such_bundle"]
    assert by_stem["squarespace"]["renders"]["1:1"] == payload["squarespace"]["1:1"]


def test_http_stats_keys_equal_jax(server, jax_svc):
    base, _ = server
    _post(base, "/v1/render", {"bundle": "audio_book", "ratio": "16:9"})
    jax_svc.render("audio_book", "16:9")
    with urllib.request.urlopen(base + "/v1/stats") as r:
        stats = json.loads(r.read())
    want = jax_svc.stats()
    assert set(stats) == set(want)
    assert set(stats["latency_ms"]) == set(want["latency_ms"])
    assert stats["requests"] >= stats["dispatches"] >= 1


def test_http_concurrent_renders_equal_sequential(server):
    base, service = server
    rng = np.random.default_rng(7)
    layouts = [_random_layout(rng, "squarespace") for _ in range(6)]

    def one(i):
        status, png, _ = _post(base, "/v1/render", {"bundle": "squarespace", "ratio": "1:1",
                                                    "layout": layouts[i % 6]})
        assert status == 200
        return np.asarray(Image.open(io.BytesIO(png)).convert("RGBA"))

    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as pool:
        outs = list(pool.map(one, range(12)))
    for i, out in enumerate(outs):
        assert np.array_equal(out, service.render("squarespace", "1:1", layouts[i % 6])[2]), i


# -------------------------------------------------------------- isolation


def test_serving_and_agentic_load_no_jax():
    code = (
        "import sys\n"
        "import image_transformation_tpu_torch.serving as s\n"
        "import image_transformation_tpu_torch.serving.server\n"
        "import image_transformation_tpu_torch.agentic as a\n"
        "import image_transformation_tpu_torch.agentic.nodes, image_transformation_tpu_torch.agentic.models\n"
        "from image_transformation_tpu_torch.ops import _build\n"
        "svc = s.ComposeService('data', '/dev/null/none.json', device='cpu')\n"
        "assert svc.render('squarespace', '1:1')[2].shape == (492, 492, 4)\n"
        "import threading\n"
        "[t.join(60) for t in threading.enumerate() if t.name == 'coalescer-drain']\n"
        "assert _build._LIB is None\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'image_transformation_tpu.'))"
        " or m == 'image_transformation_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_cuda_service_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        ComposeService("data")
    with pytest.raises(RuntimeError, match="is_available"):
        serve("data", port=0)
