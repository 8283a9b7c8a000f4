"""The percentile and rate arithmetic, on a window that holds a stall."""

import math

import numpy as np

from bench_torch.drivers.serve import latencies_ms
from bench_torch.harness import percentile


def test_percentile_matches_numpy_linear():
    rng = np.random.default_rng(3)
    v = list(rng.exponential(10.0, 999))
    for q in (50, 95, 99):
        assert math.isclose(percentile(v, q), float(np.percentile(v, q)), rel_tol=1e-12)


def test_an_open_loop_stall_counts_its_wait_for_every_later_request():
    # requests due every 10 ms take 1 ms, but the server stalls for 200 ms at
    # t = 0.1 s: each request due during the stall finishes when it ends
    due = [k * 0.010 for k in range(100)]
    done = [d + 0.001 if not (0.1 <= d < 0.3) else 0.301 for d in due]
    recs = [{"due": d, "done": e, "status": 200} for d, e in zip(due, done)]
    lat = latencies_ms(recs)
    assert math.isclose(percentile(lat, 50), 1.0, abs_tol=1e-6)
    assert percentile(lat, 95) > 100.0  # the stall shows in the tail
    # a closed loop timed from send would read 1 ms everywhere: timing from
    # the due time is what makes the stall visible
    recs[5]["status"] = 500
    assert latencies_ms(recs)[5] == float("inf")


def test_a_rate_is_taken_over_the_whole_window():
    # 1,000 steps of 256 canvases in a 10 s window that holds a 2 s stall
    steps, batch, window_s = 1000, 256, 10.0
    assert steps * batch / window_s == 25600.0
