#!/usr/bin/env python3
"""Where the hybrid compose's time goes, on one CUDA card.

    python -m tools.profile_k4

Run from the root of a checkout (it reuses chip_smoke.py's device and build
phases and its hybrid batch: squarespace, 1080x1920, B=64, boxes from seed 0
plus an identity box and an edge box). Prints:

- K4's device time per launch from torch.profiler, mean of ``REPS`` calls,
  in the unclamped and the clamped geometry, with the placement pixels it
  covers and the bytes it moves (4 per covered source pixel, 8 per plane
  pixel read and written);
- the clamped hybrid compose over ``REPS`` calls ending in one
  synchronize: host wall per call, device busy, idle share, and the device
  time of its largest kernels by name;

each line with the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import time

import torch

import chip_smoke
from image_transformation_tpu_torch.ops import compose_kernels as ck
from tools.profile_k2 import _kernel_times

REPS = 10


def _traffic(plane: torch.Tensor, src: torch.Tensor, meta: torch.Tensor):
    """(covered placement pixels, distinct plane pixels written) of one K4
    launch: the placement rectangles cut at the plane's edge."""
    B, hp, wp = plane.shape
    mh, mw = src.shape[2], src.shape[3]
    mask = torch.zeros((B, hp, wp), dtype=torch.bool, device=plane.device)
    covered = 0
    for b, rows in enumerate(meta.tolist()):
        for ws_x, ws_y, dx, dy, _, valid in rows:
            if valid <= 0:
                continue
            x, y = ws_x + dx, ws_y + dy
            covered += max(0, min(y + mh, hp) - y) * max(0, min(x + mw, wp) - x)
            mask[b, y:y + mh, x:x + mw] = True
    return covered, int(mask.sum())


def profile_k4(smi: str, device) -> None:
    _, _, canvases, objs, hw, boxes, env = chip_smoke.hybrid_inputs(device)
    for clamped in (False, True):
        producer = ck._hybrid_producer_clamped if clamped else ck._hybrid_producer
        plane, src, meta = producer(canvases, objs, hw, boxes, env, "lanczos")
        ck.window_blend(plane, src, meta)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                ck.window_blend(plane, src, meta)
            torch.cuda.synchronize()
        us = sum(v for k, v in _kernel_times(prof, REPS).items() if "window_blend" in k)
        if us == 0:
            raise RuntimeError("the profiler saw no K4 device time")
        covered, written = _traffic(plane, src, meta)
        gbytes = (4 * covered + 8 * written) / 1e9
        print(f"[profile] K4 {'clamped' if clamped else 'unclamped'} plane "
              f"{plane.shape[1]}x{plane.shape[2]} B={plane.shape[0]} N={src.shape[1]} "
              f"source {src.shape[2]}x{src.shape[3]}: {us:.1f} us per launch (mean of "
              f"{REPS}); {covered} placement pixels, {written} plane pixels written, "
              f"{gbytes:.3f} GB moved, {gbytes / (us * 1e-6):.0f} GB/s on {smi}")
        del plane, src, meta
        torch.cuda.empty_cache()


def hybrid_step(smi: str, device) -> None:
    _, _, canvases, objs, hw, boxes, _ = chip_smoke.hybrid_inputs(device)

    def compose():
        return ck.composite_batch_hybrid_packed(canvases, objs, hw, boxes, clamped=True)

    compose()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            compose()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per = _kernel_times(prof, REPS)
    busy_ms = sum(per.values()) / 1e3
    k4_ms = sum(v for k, v in per.items() if "window_blend" in k) / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    text = "; ".join(f"{k[:70]} {us:.1f} us" for k, us in top)
    print(f"[hybrid-step] clamped compose 1080x1920 B={canvases.shape[0]}: "
          f"{wall_ms / REPS:.3f} ms per call host wall under the profiler; device busy "
          f"{busy_ms:.3f} ms (K4 {k4_ms:.3f} ms, {100 * k4_ms / busy_ms:.1f}%), idle share "
          f"{1 - busy_ms * REPS / wall_ms:.3f}; {len(per)} kernels by name, largest: "
          f"{text} on {smi}")


def main() -> int:
    smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    device = torch.device("cuda", 0)
    profile_k4(smi, device)
    hybrid_step(smi, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
