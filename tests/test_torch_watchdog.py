"""The port's PhaseWatchdog (image_transformation_tpu_torch/core/watchdog.py,
a copy of image_transformation_tpu/core/watchdog.py): the five cases of
tests/test_watchdog.py with the same assertions, against the port's copy.

The exit path is injected (`_exit`) so the tests observe it without
dying; emit failures must not resurrect the silent hang.
"""

import threading
import time

from image_transformation_tpu_torch.core.watchdog import PhaseWatchdog


def _wait_for(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


def test_phases_complete_without_firing():
    fired = []
    wd = PhaseWatchdog(fired.append, _exit=fired.append)
    wd.phase("a", 30)
    wd.phase("b", 30)
    wd.done()
    assert fired == []
    hist = wd.history()
    assert [h["phase"] for h in hist] == ["a", "b"]
    assert all(h["seconds"] >= 0 for h in hist)
    # idempotent
    wd.done()
    assert [h["phase"] for h in wd.history()] == ["a", "b"]


def test_stall_emits_payload_and_exits():
    payloads = []
    exits = []
    done = threading.Event()

    def emit(p):
        payloads.append(p)

    def fake_exit(code):
        exits.append(code)
        done.set()

    wd = PhaseWatchdog(
        emit, context={"batch": 512, "note": "x"}, exit_code=3,
        _exit=fake_exit,
    )
    wd.phase("compile", 30)
    wd.phase("first_execute", 0.05)  # will overrun
    assert done.wait(5.0)
    assert exits == [3]
    (p,) = payloads
    assert p["stalled_phase"] == "first_execute"
    assert 0 <= p["deadline_s"] <= 0.1
    assert p["elapsed_s"] >= 0
    assert p["batch"] == 512 and p["note"] == "x"
    assert [h["phase"] for h in p["phase_history"]] == ["compile"]


def test_update_context_reaches_payload():
    payloads = []
    done = threading.Event()
    wd = PhaseWatchdog(
        payloads.append, _exit=lambda code: done.set()
    )
    wd.phase("alloc", 0.05)
    wd.update_context(expected_hbm_bytes=123)
    assert done.wait(5.0)
    assert payloads[0]["expected_hbm_bytes"] == 123


def test_broken_emitter_still_exits():
    done = threading.Event()

    def bad_emit(p):
        raise RuntimeError("reporter broke")

    wd = PhaseWatchdog(bad_emit, exit_code=7, _exit=lambda c: done.set())
    wd.phase("x", 0.05)
    assert done.wait(5.0)


def test_done_disarms_before_deadline():
    fired = []
    wd = PhaseWatchdog(fired.append, _exit=fired.append)
    wd.phase("quick", 0.2)
    wd.done()
    time.sleep(0.4)
    assert fired == []
