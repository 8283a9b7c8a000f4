"""The port's serving daemon shuts down: ComposeService.close(), the
server's server_close() and the interpreter's exit, on the CPU.

A process that served a render and then returns must exit 0 with no close
of its own: the atexit handler closes every open service, so no drain
worker is inside torch while the interpreter finalizes. Concurrency is
driven with ``threading.Event`` gates; the bounded waits are never reached
when the tests pass.
"""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from image_transformation_tpu_torch.serving import ComposeService, serve
from image_transformation_tpu_torch.serving import server as srv

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 60.0
COPIES = 8

#: serves one /v1/render on the CPU in process, then returns: no wait, no close()
SERVE_ONCE = """
import json, threading, urllib.request
from image_transformation_tpu_torch.serving import serve

def main():
    server = serve("data", port=0, device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.server_address[1]}/v1/render", method="POST",
        data=json.dumps({"bundle": "squarespace", "ratio": "1:1"}).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        print("status", r.status, "bytes", len(r.read()))

main()
"""

#: renders, closes, then checks what close() promises
CLOSE_ONCE = """
import threading
from image_transformation_tpu_torch.serving import ComposeService
from image_transformation_tpu_torch.serving.server import ServiceClosedError

svc = ComposeService("data", device="cpu")
svc.render("squarespace", "1:1")
svc.close()
alive = [t.name for t in threading.enumerate() if t.name == "coalescer-drain"]
assert not alive, alive
for call in (lambda: svc.render("squarespace", "1:1"),
             lambda: svc.render_batch("squarespace", ["1:1"])):
    try:
        call()
    except ServiceClosedError as e:
        assert isinstance(e, RuntimeError) and "closed" in str(e)
    else:
        raise AssertionError("a render after close() did not raise")
svc.close()  # idempotent
print("closed")
"""


def _env(tmp_path):
    env = dict(os.environ, HOME=str(tmp_path), OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    return env


def _drains_alive():
    return [t for t in threading.enumerate() if t.name == "coalescer-drain" and t.is_alive()]


def test_processes_that_never_close_exit_cleanly(tmp_path):
    """Eight copies at once, each serving one /v1/render and returning
    with no close(): every one exits 0 (with the worker left to the
    interpreter, most such copies aborted with exit 134)."""
    procs = [subprocess.Popen([sys.executable, "-c", SERVE_ONCE], cwd=ROOT, env=_env(tmp_path),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(COPIES)]
    results = [(p.wait(timeout=300), *p.communicate()) for p in procs]
    for rc, out, err in results:
        assert rc == 0 and "status 200" in out, f"exit {rc}\n{out}\n{err}"


def test_close_retires_workers_and_later_renders_raise(tmp_path):
    r = subprocess.run([sys.executable, "-c", CLOSE_ONCE], cwd=ROOT, env=_env(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "closed", r.stderr


def test_close_during_an_idle_calibration_waits_for_the_worker(monkeypatch, tmp_path):
    """close() while the idle calibration runs returns only once the worker
    has retired; before that, a close() whose timeout runs out raises and
    names the worker."""
    monkeypatch.setattr(srv, "_CALIB_TTL_S", 120.0)
    svc = ComposeService("data", tmp_path / "steps.json", device="cpu")
    placements, canvas_size = svc.solve("squarespace", "1:1")
    coal = svc._coalescer("squarespace", canvas_size, "solid")
    started, gate, calls = threading.Event(), threading.Event(), []

    def gated_measure(sets, reps, floor_ms):
        calls.append(reps)
        started.set()
        assert gate.wait(WAIT_S)
        return 1.0

    monkeypatch.setattr(coal.engine, "measure_device_ms", gated_measure)
    coal.render(placements)
    assert started.wait(WAIT_S)  # the worker is inside the calibration
    worker = coal._worker
    with pytest.raises(RuntimeError, match="coalescer-drain"):
        svc.close(timeout=0.2)
    assert worker.is_alive()
    closer = threading.Thread(target=svc.close)
    closer.start()
    time.sleep(0.2)
    assert closer.is_alive()  # still waiting for the worker
    gate.set()
    closer.join(WAIT_S)
    assert not closer.is_alive() and not worker.is_alive() and not _drains_alive()
    # the refresh stopped at close(): the probe and one reading, no more
    assert len(calls) == 2
    with pytest.raises(srv.ServiceClosedError):
        coal.render(placements)


def test_close_joins_a_dropped_fleet_stream(monkeypatch, tmp_path):
    """A streaming fleet generator dropped after its first item leaves a
    bundle's render_batch running; close() waits for it and joins the
    pool's threads."""
    svc = ComposeService("data", tmp_path / "steps.json", device="cpu")
    real, held, release = svc.render_batch, threading.Event(), threading.Event()

    def render_batch(stem, ratios, **kw):
        if stem == "audio_book":
            held.set()
            assert release.wait(WAIT_S)
        return real(stem, ratios, **kw)

    monkeypatch.setattr(svc, "render_batch", render_batch)
    stream = svc.render_fleet_iter(["audio_book", "squarespace"], ["1:1", "9:16"], parallel=2)
    stem, entry = next(stream)
    assert stem == "squarespace" and "renders" in entry
    assert held.wait(WAIT_S)
    del stream  # the generator closes: queued bundles dropped, running ones not
    fleet = [t for t in threading.enumerate() if t.name.startswith("render-fleet")]
    assert any(t.is_alive() for t in fleet)
    closer = threading.Thread(target=svc.close)
    closer.start()
    time.sleep(0.2)
    assert closer.is_alive()  # waiting for the held bundle
    release.set()
    closer.join(WAIT_S)
    assert not closer.is_alive()
    assert not any(t.is_alive() for t in fleet) and not svc._fleet_pools


def test_server_close_closes_only_the_service_serve_built(tmp_path):
    built = serve("data", port=0, device="cpu")
    given = ComposeService("data", tmp_path / "steps.json", device="cpu")
    passed = serve("data", port=0, service=given)
    for daemon in (built, passed):
        daemon.server_close()
    with pytest.raises(srv.ServiceClosedError):
        built.service.render("squarespace", "1:1")
    assert given.render("squarespace", "1:1")[2].shape == (492, 492, 4)
    given.close()
    assert not _drains_alive()


def test_warm_start_thread_is_joined_by_close(tmp_path):
    manifest = tmp_path / "steps.json"
    first = ComposeService("data", manifest, device="cpu")
    first.render_batch("squarespace", ["1:1"])
    first.close()
    svc = ComposeService("data", manifest, device="cpu")
    thread = svc.warm_start_in_background()
    svc.close()
    assert not thread.is_alive()
    with pytest.raises(srv.ServiceClosedError):
        svc.warm_start_in_background()
