#!/usr/bin/env python3
"""Where K1's time goes, on one CUDA card.

    python -m tools.profile_k1

Run from the root of a checkout (it reuses chip_smoke.py's inputs). Prints:

- per-launch device time of K1's three launches (bounds, resample, blend),
  from torch.profiler over ``REPS`` calls, at chip_smoke.py's two
  geometries (squarespace at 9:16 B=1, and 1080x1920 B=64 shared objects);
- the host wall time of a warm ``ComposeEngine.compose`` at 9:16
  (including a synchronize), p50/p90, on a table-cache hit and with new
  boxes on every call (host table build + upload);
- the host cost of each step of a K1 wrapper call at B=1 (argument check,
  stream handle by the public and the private query, device guard always
  and where needed, scratch allocation; ``HOST_REPS`` calls of each), the
  whole call's host time, and its CUDA-event time as chip_smoke.py takes
  it, in 5 rounds (``wrapper_costs``, which tools/profile_k2.py and
  tools/profile_k4.py use for K3 and K4);

each line with the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np
import torch

import chip_smoke
from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.layout.canvas import compute_canvas_size
from image_transformation_tpu_torch.ops.background import synthesize_canvas
from image_transformation_tpu_torch.ops.compose_kernels import fused_compose
from image_transformation_tpu_torch.parallel.sweep import random_downscale_boxes
from image_transformation_tpu_torch.pipeline.engine import ComposeEngine

REPS = 5
HOST_REPS = 5000
KERNELS = chip_smoke.K1_LAUNCHES  # (label, a substring of the kernel's name)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise AttributeError("profiler event has no device time")


def profile_launches(name, hw, batch, smi, device):
    canvas, objects, tables = chip_smoke._geometry_inputs(
        chip_smoke.ROOT / "data" / "squarespace", hw, batch, 0, device
    )
    fused_compose(canvas, objects, *tables)
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        for _ in range(REPS):
            fused_compose(canvas, objects, *tables)
        torch.cuda.synchronize()
    per = {label: 0.0 for label, _ in KERNELS}
    for evt in prof.key_averages():
        for label, key in KERNELS:
            if key in evt.key:
                per[label] += _device_us(evt) / REPS
    total = sum(per.values())
    if total == 0:
        raise RuntimeError(f"{name}: the profiler saw no device time")
    parts = ", ".join(
        f"{label} {us:.1f} us ({100 * us / total:.0f}%)" for label, us in per.items()
    )
    print(f"[profile] {name}: canvas {hw[0]}x{hw[1]} B={batch}: {parts}; "
          f"sum {total:.1f} us per call, mean of {REPS} on {smi}")


def time_engine(smi, device, reps=200):
    bundle = load_bundle(chip_smoke.ROOT / "data" / "squarespace")
    arrays = bundle.to_arrays()
    W, H = compute_canvas_size(bundle.background.size, "9:16", verbose=False)
    bg = torch.from_numpy(np.asarray(bundle.background).copy()).to(device)
    engine = ComposeEngine(arrays, synthesize_canvas(bg, W, H, "solid"), device)
    live = [k for k, oid in enumerate(arrays.object_ids) if oid >= 0]
    ids = [int(arrays.object_ids[k]) for k in live]
    rng = np.random.default_rng(0)

    def placements():
        boxes = random_downscale_boxes(rng, arrays.obj_hw[live], (H, W))
        return [{"object_id": oid, "box": [int(v) for v in box]}
                for oid, box in zip(ids, boxes)]

    def wall_ms(make):
        times = []
        for _ in range(reps):
            p = make()
            t0 = time.perf_counter()
            engine.compose(p)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        q = statistics.quantiles(times, n=10)
        return statistics.median(times), q[-1]

    fixed = placements()
    engine.compose(fixed)
    torch.cuda.synchronize()
    hit = wall_ms(lambda: fixed)
    new = wall_ms(placements)
    print(f"[engine] compose 9:16 canvas {H}x{W}, {reps} calls: cache hit p50 {hit[0]:.3f} ms "
          f"p90 {hit[1]:.3f} ms; new boxes p50 {new[0]:.3f} ms p90 {new[1]:.3f} ms "
          f"on {smi}")


def host_costs(smi, device):
    """Per-call host microseconds of the K1 wrapper's steps at the CLI
    geometry, and the wrapper's CUDA-event ms as chip_smoke.py times it."""
    from image_transformation_tpu_torch.ops import compose_kernels as ck

    w9, h9 = compute_canvas_size((970, 250), "9:16", verbose=False)
    canvas, objects, tables = chip_smoke._geometry_inputs(
        chip_smoke.ROOT / "data" / "squarespace", (h9, w9), 1, 0, device
    )
    B, N, mh, mw = 1, objects.shape[1], tables[1].shape[2], tables[0].shape[2]
    nbytes = ck._k1_scratch_bytes(B, N, mh, mw)

    def guard():
        with torch.cuda.device(device):
            pass

    def guard_if_needed():
        with (contextlib.nullcontext() if device.index == torch.cuda.current_device()
              else torch.cuda.device(device)):
            pass

    steps = {
        "check": lambda: ck._check_args(canvas, objects, *tables),
        "stream (public)": lambda: torch.cuda.current_stream(device).cuda_stream,
        "stream (private raw)": lambda: torch._C._cuda_getCurrentRawStream(device.index),
        "device guard": guard,
        "device guard where needed": guard_if_needed,
        "stream (wrapper)": lambda: ck._stream_handle(device),
        "scratch": lambda: torch.empty(nbytes, dtype=torch.uint8, device=device),
        "data_ptr x7": lambda: [t.data_ptr() for t in (canvas, objects, *tables, canvas)],
    }
    wrapper_costs(f"K1 wrapper steps at {h9}x{w9} B=1", steps,
                  lambda: fused_compose(canvas, objects, *tables), smi)


def _launch_host_us(call, reps: int = 200) -> float:
    """Median host microseconds of ``call`` (which launches work), each call
    on an idle device (synchronized after, outside the timed span)."""
    host = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        host.append(1e6 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    return statistics.median(host)


def wrapper_costs(label: str, steps: dict, call, smi: str, reps: int = HOST_REPS,
                  launching: dict | None = None) -> None:
    """Print the host microseconds per call of each step in ``steps`` (name
    -> function) over ``reps`` calls, of each step in ``launching`` (steps
    that launch kernels, each timed on an idle device, median of 200), the
    whole ``call``'s host time (the same way: what it keeps an idle device
    waiting), and its CUDA-event ms as chip_smoke.py takes it, in 5
    rounds."""
    parts = []
    for name, fn in steps.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        parts.append(f"{name} {1e6 * (time.perf_counter() - t0) / reps:.2f}")
    torch.cuda.synchronize()
    one = torch.zeros(16, device=torch.cuda.current_device())
    launching = {"one torch launch (zero_ of 16 floats)": one.zero_, **(launching or {})}
    parts += [f"{name} {_launch_host_us(fn):.2f}" for name, fn in launching.items()]
    print(f"[host] {label}, us per call: {', '.join(parts)}; the whole call "
          f"{_launch_host_us(call):.2f} us of host time (median of 200) on {smi}")
    rounds = [chip_smoke.cuda_ms(call, 8) for _ in range(5)]
    print(f"[host] {label}: the call's CUDA-event ms (median of 8), 5 rounds: "
          f"{', '.join(f'{r:.3f}' for r in rounds)} on {smi}")


def main() -> int:
    smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    device = torch.device("cuda", 0)
    w9, h9 = compute_canvas_size((970, 250), "9:16", verbose=False)
    profile_launches("cli_9x16_b1", (h9, w9), 1, smi, device)
    profile_launches("serve_1080p_b64", (1080, 1920), 64, smi, device)
    time_engine(smi, device)
    host_costs(smi, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
