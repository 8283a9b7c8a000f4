"""The render daemon of the ``serve`` driver, in a process of its own so that
the load generator does not share its interpreter lock:

    python3 -m bench_torch.daemon --bundles-root <dir> --manifest <file>

It builds the program's ``serving.server.serve()`` on the card on a free
local port, prints ``{"port": ..., "device_name": ...}``, and then takes one
JSON command per line on standard input, answering each with one JSON line:
``trace_start`` / ``trace_stop`` (the profiler window and its reduction),
``stats`` (the process's device memory peak), ``gc_pauses`` (the
interpreter's collector pauses since the last ask) and ``quit``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import threading
import time

from .run import CACHES, CHECKOUT


def _reply(obj) -> None:
    print(json.dumps(obj), flush=True)


class _Pauses:
    """The interpreter's garbage-collector pauses in this process (s), by generation."""

    def __init__(self):
        self.t0 = 0.0
        self.pauses = {0: [], 1: [], 2: []}
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if phase == "start":
            self.t0 = time.perf_counter()
        else:
            self.pauses[info["generation"]].append(time.perf_counter() - self.t0)

    def take(self):
        out = {f"gen{g}": [len(v), sum(v), max(v, default=0.0)] for g, v in self.pauses.items()}
        self.pauses = {0: [], 1: [], 2: []}
        return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--bundles-root", required=True)
    parser.add_argument("--manifest", required=True)
    parser.add_argument("--device", default="cuda", help="cuda, or cpu for the harness's own tests")
    args = parser.parse_args(argv)
    cuda = args.device == "cuda"
    for var, rel in CACHES.items():
        os.environ.setdefault(var, str(CHECKOUT / rel))

    import torch
    from torch.profiler import record_function

    from image_transformation_tpu_torch.serving.server import ComposeService, serve

    from . import trace as tracing

    service = ComposeService(args.bundles_root, manifest_path=args.manifest, device=args.device)
    server = serve(args.bundles_root, host="127.0.0.1", port=0, service=service)
    thread = threading.Thread(target=server.serve_forever, name="bench-daemon-http", daemon=True)
    thread.start()
    _reply({"port": server.server_address[1],
            "device_name": torch.cuda.get_device_name() if cuda else "cpu"})
    pauses = _Pauses()
    prof = window = None
    try:
        for line in sys.stdin:
            op = json.loads(line)["op"]
            if op == "trace_start":
                if cuda:
                    torch.cuda.synchronize()
                prof = tracing.profiler()
                prof.start()
                window = record_function(tracing.WINDOW)
                window.__enter__()
                _reply({"ok": True})
            elif op == "trace_stop":
                if cuda:
                    torch.cuda.synchronize()
                window.__exit__(None, None, None)
                prof.stop()
                _reply(tracing.reduce(tracing.raw_events(prof)))
                prof = window = None
            elif op == "stats":
                _reply({"memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0})
            elif op == "gc_pauses":  # [count, total s, longest s] per generation since the last ask
                _reply(pauses.take())
            elif op == "quit":
                break
    finally:
        server.shutdown()
        thread.join(timeout=60)
        server.server_close()
        service.close()
    _reply({"closed": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
