"""Driver ``serve``: the render daemon under an open loop of independent users.

The daemon (``bench_torch.daemon``: the program's ``serving.server.serve()``
on the card) runs in a child process. This process, which never touches the
card, offers ``POST /v1/render`` requests at Poisson arrivals of the mix's
fixed rate: each request's ratio, background and layout are drawn (layouts
by Zipf popularity over a pool of distinct ones, so popular templates
repeat) from the mix's fixed traffic seed, so that every run offers the
same work, and ``--seed`` shuffles the order of the requests and of the
arrival gaps. Each request is timed from when it was due to be sent;
workers on keep-alive connections send it at its due time or, when all are
busy, as soon as one frees (how late the generator ran is printed).
"""

from __future__ import annotations

import gc
import http.client
import json
import subprocess
import sys
import threading
import time
from typing import Dict, List

import numpy as np

from .. import reference, traffic
from ..harness import CHECKOUT, Check, median, percentile


class Daemon:
    """The child process and its command pipe."""

    def __init__(self, root, device: str):
        manifest = CHECKOUT / ".bench_cache" / "serving_steps.json"
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "bench_torch.daemon", "--bundles-root", str(root),
             "--manifest", str(manifest), "--device", device],
            cwd=str(CHECKOUT), stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        hello = self._read()
        self.port, self.device_name = hello["port"], hello["device_name"]

    def _read(self):
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the daemon exited (rc {self.proc.wait()})")
        return json.loads(line)

    def ask(self, op: str):
        self.proc.stdin.write(json.dumps({"op": op}) + "\n")
        self.proc.stdin.flush()
        return self._read()

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.ask("quit")
                self._read()
            except (RuntimeError, OSError, ValueError):
                pass
            try:
                self.proc.wait(timeout=90)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


class LoadGen:
    """Open-loop sender of a fixed schedule over ``workers`` connections."""

    def __init__(self, port: int, workers: int):
        self.port, self.workers = port, workers

    def get(self, path: str) -> Dict:
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        try:
            conn.request("GET", path)
            return json.loads(conn.getresponse().read())
        finally:
            conn.close()

    def run(self, schedule: List[float], bodies: List[bytes], keep=()) -> List[Dict]:
        """Send ``bodies[k]`` at ``schedule[k]`` s after the start; returns one
        record per request (due, sent, done on the start's clock, status,
        timings header, and the response body for the indices in ``keep``)."""
        keep = set(keep)
        out: List[Dict] = [None] * len(schedule)
        lock = threading.Lock()
        nxt = [0]
        t0 = time.perf_counter() + 0.05

        def worker():
            conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
            while True:
                with lock:
                    k = nxt[0]
                    nxt[0] += 1
                if k >= len(schedule):
                    break
                wait = t0 + schedule[k] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                sent = time.perf_counter()
                rec = {"due": schedule[k], "sent": sent - t0, "status": 0}
                try:
                    conn.request("POST", "/v1/render", body=bodies[k],
                                 headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    body = resp.read()
                    if k in keep:
                        rec["body"] = body
                    rec["status"] = resp.status
                    rec["timings"] = json.loads(resp.getheader("X-Render-Timings") or "{}")
                except (OSError, http.client.HTTPException) as e:
                    rec["error"] = repr(e)
                    conn.close()
                    conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
                rec["done"] = time.perf_counter() - t0
                out[k] = rec
            conn.close()

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=schedule[-1] + 180 if schedule else 180)
        return [r if r is not None else {"due": schedule[k], "status": 0, "error": "never sent"}
                for k, r in enumerate(out)]


def latencies_ms(records: List[Dict]) -> List[float]:
    """Each request's time from due to done; a failed one never meets a limit."""
    return [(r["done"] - r["due"]) * 1e3 if r.get("status") == 200 else float("inf")
            for r in records]


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.attempted = self.failed = 0
        self.remote_trace = True
        self.daemon = None

    def _traffic(self, order, seconds, rate, stream):
        """(send times, requests) of ``seconds`` at ``rate``. The arrivals'
        gaps and the multiset of requests come from the mix's fixed
        ``traffic_seed`` (and ``stream``), so every run seed offers the same
        work; the run's generator ``order`` shuffles both."""
        p = self.ctx.param
        base = np.random.default_rng([p("traffic_seed"), *stream])
        times = traffic.poisson_arrivals(base, rate, seconds)
        n = len(times)
        ratios = base.integers(0, len(p("ratios")), size=n)
        bgs = base.integers(0, len(p("backgrounds")), size=n)
        which = traffic.zipf_indices(base, len(self.layouts), p("zipf_s"), n)
        gaps = np.diff(np.concatenate([[0.0], times]))[order.permutation(n)]
        reqs = [{"bundle": self.stem, "ratio": p("ratios")[r], "background": p("backgrounds")[b],
                 "layout": self.layouts[w]} for r, b, w in zip(ratios, bgs, which)]
        return list(np.cumsum(gaps)), [reqs[i] for i in order.permutation(n)]

    def setup(self):
        p = self.ctx.param
        bundle_dir = CHECKOUT / self.ctx.cell.config["bundle"]
        self.stem = bundle_dir.name
        _, objects = reference.load_bundle(bundle_dir)
        self.layouts = traffic.unique_layouts(np.random.default_rng(p("traffic_seed")),
                                              sorted(objects), p("layouts"), p("spacing"))
        t0 = time.perf_counter()
        self.daemon = Daemon(bundle_dir.parent, self.ctx.device)
        self.ctx.device_name = self.daemon.device_name
        self.load = LoadGen(self.daemon.port, p("workers"))
        t1 = time.perf_counter()
        # warm-up: the mix itself, its rate reached in steps (every engine and
        # call cache it builds); then on every engine bursts of 3, 5 and 9
        # distinct requests, whose queued tails merge into 2, 4 and 8 sets;
        # then idle until the daemon has calibrated each merge size it saw
        warm = []
        for k, (share, secs) in enumerate(p("warmup_ramp")):
            times, reqs = self._traffic(np.random.default_rng([self.ctx.seed, 2, k]), secs,
                                        share * p("rate"), (2, k))
            warm += latencies_ms(self.load.run(times, [json.dumps(q).encode() for q in reqs]))
        t2 = time.perf_counter()
        order = np.random.default_rng([self.ctx.seed, 4]).permutation(len(self.layouts))
        n = 0
        for r in p("ratios"):
            for b in p("backgrounds"):
                for size in (3, 5, 9):
                    burst = [{"bundle": self.stem, "ratio": r, "background": b,
                              "layout": self.layouts[order[(n + i) % len(order)]]}
                             for i in range(size)]
                    n += size
                    self.load.run([0.0] * size, [json.dumps(q).encode() for q in burst])
        t3 = time.perf_counter()
        self._settle(p("settle_seconds"))
        print(f"serve: set-up daemon {t1 - t0:.3f} s, warm traffic {t2 - t1:.3f} s "
              f"({len(warm)} requests, p50 {percentile(warm, 50):.3f} ms, max {max(warm):.3f} ms), "
              f"bursts {t3 - t2:.3f} s, settle {time.perf_counter() - t3:.3f} s", file=sys.stderr)

    def _settle(self, most_s: float) -> None:
        """Wait, up to ``most_s``, until the daemon is idle: nothing queued and
        no device calibration changed over the last second."""
        last = None
        deadline = time.perf_counter() + most_s
        while time.perf_counter() < deadline:
            st = self.load.get("/v1/stats")
            calib = json.dumps({k: sorted((kk, len(v.get("samples", []))) for kk, v in e.items())
                                for k, e in st.get("device_calibration", {}).items()},
                               sort_keys=True)
            if calib == last and not st.get("backlog_age_s"):
                return
            last = calib
            time.sleep(1.0)

    def window(self, seconds):
        p = self.ctx.param
        times, reqs = self._traffic(np.random.default_rng([self.ctx.seed, 3]), seconds, p("rate"),
                                    (3,))
        before = self.load.get("/v1/stats")
        self.daemon.ask("gc_pauses")
        if self.ctx.trace:
            self.daemon.ask("trace_start")
        pick = np.random.default_rng([self.ctx.seed, 1]).permutation(len(reqs))[:p("samples")]
        bodies = [json.dumps(q).encode() for q in reqs]
        gc.collect()
        gc.disable()  # no collector pause in the load generator while it sends
        try:
            records = self.load.run(times, bodies, keep=pick)
        finally:
            gc.enable()
        if self.ctx.trace:
            self.trace_summary = self.daemon.ask("trace_stop")
        after = self.load.get("/v1/stats")
        print(f"serve: daemon collector pauses in the window [count, s, longest s]: "
              f"{self.daemon.ask('gc_pauses')}", file=sys.stderr)
        self.attempted = len(records)
        self.failed = sum(1 for r in records if r.get("status") != 200)
        lat = latencies_ms(records)
        q = max(1, len(lat) // 4)
        print("serve: request p95 by quarter of the window (ms): " + ", ".join(
            f"{percentile(lat[i:i + q], 95):.3f}" for i in range(0, 4 * q, q)), file=sys.stderr)
        late = [(r["sent"] - r["due"]) * 1e3 for r in records if "sent" in r]
        print(f"serve: {len(records)} requests at {p('rate')} req/s offered; generator late "
              f"p50 {percentile(late, 50):.3f} ms, p95 {percentile(late, 95):.3f} ms, "
              f"max {max(late):.3f} ms; failed {self.failed}", file=sys.stderr)
        ok = [r for r in records if r.get("status") == 200]
        c = self.ctx.counters
        c["request_p50_ms"] = percentile(lat, 50)
        c["encode_ms"] = median([r["timings"].get("encode_ms", 0.0) for r in ok])
        c["queue_ms"] = median([r["timings"].get("queue_ms", 0.0) for r in ok])
        d_req = after["requests"] - before["requests"]
        c["dispatches_per_request"] = (after["dispatches"] - before["dispatches"]) / d_req if d_req else None
        self.sampled = [(reqs[i], records[i]["body"]) for i in pick
                        if records[i].get("status") == 200]
        window_s = max(r.get("done", 0.0) for r in records)
        recent = sum(1 for e in after.get("device_calibration", {}).values()
                     for cal in e.values() if cal.get("age_s", 1e9) < window_s)
        print(f"serve: daemon calibrations refreshed inside the window: {recent}", file=sys.stderr)
        return {"request_p95_ms": percentile(lat, 95)}

    def memory_peak_bytes(self) -> int:
        return int(self.daemon.ask("stats")["memory_peak_bytes"])

    def release(self):
        if self.daemon is not None:
            self.daemon.close()

    def check(self, precision="exact"):
        bg, objects = reference.load_bundle(CHECKOUT / self.ctx.cell.config["bundle"])
        sizes = {oid: (o.shape[1], o.shape[0]) for oid, o in objects.items()}
        pix = 0
        for req, body in self.sampled:
            wh = reference.canvas_size((bg.shape[1], bg.shape[0]), req["ratio"])
            want = reference.solve(req["layout"]["root"], wh, sizes)
            base = reference.background_canvas(bg, wh, req["background"])
            ref = reference.compose(base, objects, want, "cpu").numpy()
            if precision == "exact":
                got = reference.decode_png(body)
            else:
                got = reference.compose(base, objects, want, "cpu", precision).numpy()
            pix = max(pix, int(np.abs(got.astype(np.int16) - ref).max())
                      if got.shape == ref.shape else 255)
        return [Check("png_max_err", pix, self.ctx.cell.mix["limits"]["png_max_err"])]
