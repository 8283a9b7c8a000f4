"""Find the serving knee once, on the card: the highest offered rate whose
request p95 stays within a limit with no growing backlog.

    python3 -m bench_torch.knee --workload <cell> --seed <n> --rates 40,80,... --seconds 8

One daemon and one warm-up, then a window per rate (low to high), each
with its own Poisson schedule from the seed. A backlog grows when the last
quarter's median latency exceeds twice the first quarter's. One JSON line
per rate; the cell's mix file records the knee and the fixed rate taken
from it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .run import CACHES, CHECKOUT


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=8.0)
    parser.add_argument("--p95-limit-ms", type=float, default=100.0)
    args = parser.parse_args(argv)
    for var, rel in CACHES.items():
        os.environ[var] = str(CHECKOUT / rel)

    import numpy as np

    from . import harness
    from .drivers.serve import latencies_ms

    cell = harness.load_cell(args.workload, pending=True)
    ctx = harness.Context(cell, args.seed, "cuda", harness.Spans(False), False)
    driver = harness.load_driver(ctx)
    driver.setup()
    try:
        for k, rate in enumerate(float(r) for r in args.rates.split(",")):
            driver.daemon.ask("gc_pauses")
            times, reqs = driver._traffic(np.random.default_rng([args.seed, 10 + k]),
                                          args.seconds, rate, (10 + k,))
            recs = driver.load.run(times, [json.dumps(q).encode() for q in reqs])
            lat = latencies_ms(recs)
            q = max(1, len(lat) // 4)
            first, last = harness.median(lat[:q]), harness.median(lat[-q:])
            done = [r["done"] for r in recs if "done" in r]
            p95 = harness.percentile(lat, 95)
            print(json.dumps({
                "rate": rate, "requests": len(recs),
                "completed_per_s": len(done) / max(done) if done else 0.0,
                "p50_ms": harness.percentile(lat, 50), "p95_ms": p95,
                "first_quarter_p50_ms": first, "last_quarter_p50_ms": last,
                "failed": sum(1 for r in recs if r.get("status") != 200),
                "sustained": bool(p95 <= args.p95_limit_ms and last <= 2 * first),
                "daemon_gc_pauses": driver.daemon.ask("gc_pauses"),
            }), flush=True)
    finally:
        driver.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
