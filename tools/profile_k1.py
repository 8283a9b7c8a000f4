#!/usr/bin/env python3
"""Where K1's time goes, on one CUDA card.

    python -m tools.profile_k1

Run from the root of a checkout (it reuses chip_smoke.py's inputs). Prints:

- per-launch device time of K1's three launches (H pass, V pass, blend),
  from torch.profiler over ``REPS`` calls, at chip_smoke.py's two
  geometries (squarespace at 9:16 B=1, and 1080x1920 B=64 shared objects);
- the host wall time of a warm ``ComposeEngine.compose`` at 9:16
  (including a synchronize), p50/p90, on a table-cache hit and with new
  boxes on every call (host table build + upload);

each line with the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

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
KERNELS = ("hpass_kernel", "vpass_kernel", "blend_kernel")


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
    per = {k: 0.0 for k in KERNELS}
    for evt in prof.key_averages():
        for k in KERNELS:
            if k in evt.key:
                per[k] += _device_us(evt) / REPS
    total = sum(per.values())
    if total == 0:
        raise RuntimeError(f"{name}: the profiler saw no device time")
    parts = ", ".join(
        f"{k.split('_')[0]} {us:.1f} us ({100 * us / total:.0f}%)" for k, us in per.items()
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


def main() -> int:
    smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    device = torch.device("cuda", 0)
    w9, h9 = compute_canvas_size((970, 250), "9:16", verbose=False)
    profile_launches("cli_9x16_b1", (h9, w9), 1, smi, device)
    profile_launches("serve_1080p_b64", (1080, 1920), 64, smi, device)
    time_engine(smi, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
