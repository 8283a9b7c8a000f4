#!/usr/bin/env python3
"""Where the batched solid render's time goes, on one CUDA card.

    python -m tools.profile_k2

Run from the root of a checkout (it reuses chip_smoke.py's device and build
phases). Squarespace objects shared, 1080x1920 canvases, boxes from
``random_downscale_boxes`` seed 0, per-object static windows. Prints:

- per-launch device time of K2's two launches (resample, blend)
  from torch.profiler, mean of ``REPS`` calls, at B=64 and B=256;
- the render step at B=256 with a fresh plane (fill + K2) against the
  reuse step (K3 restore + K2, in place), CUDA-event medians over
  alternating box sets, with each launch's device time per step;
- the K3 wrapper's host steps at B=64, its whole host time and its
  CUDA-event time (tools/profile_k1.py ``wrapper_costs``);
- the sweep's solid render step at B=256 (stat "luma", then "fence";
  reuse on): host
  wall per step over ``REPS`` steps ending in one fence, the device time
  of every kernel in that window by name, and the device's idle share
  (1 - busy / wall);

each line with the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import statistics
import time
from collections import defaultdict

import numpy as np
import torch

import chip_smoke
from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.parallel.sweep import (
    make_solid_render_step,
    random_downscale_boxes,
)
from tools.profile_k1 import _device_us, wrapper_costs

REPS = 10
HW = (1080, 1920)
K2_LAUNCHES = chip_smoke.K2_LAUNCHES  # (label, a substring of the kernel's name)


class Inputs:
    """Shared planar squarespace objects and box sets on the card."""

    def __init__(self, batch: int, device):
        bundle = load_bundle(chip_smoke.ROOT / "data" / "squarespace")
        arrays = bundle.to_arrays()
        n = arrays.obj_hw.shape[0]
        self.static = tuple(tuple(int(v) for v in row) for row in arrays.obj_hw)
        self.objs_p = ck.planarize_objects(torch.from_numpy(arrays.objects).to(device)[None])
        self.hw = torch.from_numpy(np.broadcast_to(arrays.obj_hw, (batch, n, 2)).copy()).to(device)
        self.bg = ck.pack_rgba_scalar((128, 128, 128, 255))
        self.boxes = []
        for seed in range(4):
            rng = np.random.default_rng(seed)
            self.boxes.append(torch.from_numpy(np.stack(
                [random_downscale_boxes(rng, arrays.obj_hw, HW) for _ in range(batch)]
            )).to(device))

    def fresh(self, boxes):
        return ck.render_solid_fused_v3_program(
            self.objs_p, self.hw, boxes, HW, self.bg, pipelined=True,
            static_obj_hw=self.static)

    def reuse(self, plane, prev, boxes):
        return ck.render_solid_fused_v3_reuse_program(
            plane, prev, self.objs_p, self.hw, boxes, HW, self.bg,
            static_obj_hw=self.static, pipelined=True)


def _kernel_times(prof, reps: int):
    """Device time per kernel name (device events only: a CPU op's own
    device time repeats its kernels'), divided by ``reps``."""
    per = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = _device_us(evt)
        if us > 0:
            per[evt.key] += us / reps
    return per


def profile_k2(batch: int, smi: str, device) -> None:
    inp = Inputs(batch, device)
    geo = ck.render_geometry(HW, inp.objs_p.shape[3:], inp.objs_p.shape[1], inp.static,
                             pipelined=True)
    meta, env, (hp, wp) = geo.meta(inp.hw, inp.boxes[0]), geo.envelope, geo.pad
    plane = torch.full((batch, hp, wp), inp.bg, dtype=torch.int32, device=device)
    ck.fused_v3(plane, inp.objs_p, meta, env)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            ck.fused_v3(plane, inp.objs_p, meta, env)
        torch.cuda.synchronize()
    per = _kernel_times(prof, REPS)
    parts = {label: sum(us for name, us in per.items() if key in name)
             for label, key in K2_LAUNCHES}
    total = sum(parts.values())
    if total == 0:
        raise RuntimeError(f"B={batch}: the profiler saw no device time")
    text = ", ".join(f"{label} {us:.1f} us ({100 * us / total:.0f}%)" for label, us in parts.items())
    print(f"[profile] K2 1080x1920 B={batch}: {text}; sum {total:.1f} us per call, "
          f"mean of {REPS} on {smi}")
    del plane
    torch.cuda.empty_cache()


def reuse_vs_fresh(batch: int, smi: str, device) -> None:
    inp = Inputs(batch, device)
    sets = inp.boxes

    def fresh_steps():
        for bx in sets:
            inp.fresh(bx)

    plane_cell = [inp.fresh(sets[-1])]

    def reuse_steps():
        prev = sets[-1]
        for bx in sets:
            plane_cell[0] = inp.reuse(plane_cell[0], prev, bx)
            prev = bx

    n = len(sets)
    f1 = chip_smoke.cuda_ms(fresh_steps, REPS) / n
    r1 = chip_smoke.cuda_ms(reuse_steps, REPS) / n
    r2 = chip_smoke.cuda_ms(reuse_steps, REPS) / n
    f2 = chip_smoke.cuda_ms(fresh_steps, REPS) / n
    launches = {}
    for name, steps, first in (("fresh", fresh_steps, ("fill", "fill")),
                               ("reuse", reuse_steps, chip_smoke.K3_LAUNCHES[0])):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            steps()
            torch.cuda.synchronize()
        per = _kernel_times(prof, n)
        launches[name] = ", ".join(
            f"{label} {sum(us for k, us in per.items() if key.lower() in k.lower()):.1f} us"
            for label, key in (first, *K2_LAUNCHES))
    print(f"[reuse] 1080x1920 B={batch} per step, median of {REPS} x {n} steps: fresh "
          f"(fill + K2) {min(f1, f2):.3f} ms ({f1:.3f}, {f2:.3f}); reuse (K3 + K2) "
          f"{min(r1, r2):.3f} ms ({r1:.3f}, {r2:.3f}); device time per step of each launch "
          f"(torch.profiler): fresh {launches['fresh']}; reuse {launches['reuse']} on {smi}")
    del plane_cell
    torch.cuda.empty_cache()


def host_costs(batch: int, smi: str, device) -> None:
    """The K3 wrapper's host steps on the windows of a B=``batch`` render
    (per-object static windows, as chip_smoke.py's [batched] line)."""
    inp = Inputs(batch, device)
    geo = ck.render_geometry(HW, inp.objs_p.shape[3:], inp.objs_p.shape[1], inp.static,
                             pipelined=True)
    meta, env, (hp, wp) = geo.meta(inp.hw, inp.boxes[0]), geo.envelope, geo.pad
    plane = torch.full((batch, hp, wp), inp.bg, dtype=torch.int32, device=device)
    ck.fused_v3(plane, inp.objs_p, meta, env)
    win = geo.windows
    origins = meta[..., :2].contiguous()
    steps = {
        "check": lambda: ck._check_restore_args(plane, origins, len(win)),
        "extents table (cached)": lambda: ck._restore_table(win, device),
        "device guard where needed": lambda: ck._device_guard(device).__enter__(),
        "stream (wrapper)": lambda: ck._stream_handle(device),
    }
    fn = ck._kernel_entry("restore_windows_launch")
    ext_d, max_wh = ck._restore_table(win, device)
    args = (plane.data_ptr(), origins.data_ptr(), ext_d.data_ptr(), batch, len(win), hp, wp,
            max_wh, inp.bg, ck._stream_handle(device))
    wrapper_costs(f"K3 wrapper steps at 1080x1920 B={batch}", steps,
                  lambda: ck.restore_windows(plane, origins, win, inp.bg), smi, reps=2000,
                  launching={"C entry (the launch)": lambda: fn(*args)})
    del plane
    torch.cuda.empty_cache()


def sweep_step(batch: int, stat_name: str, smi: str, device) -> None:
    inp = Inputs(batch, device)
    step = make_solid_render_step(HW, inp.objs_p.shape[3:], static_obj_hw=inp.static,
                                  stat=stat_name, device=str(device))
    for bx in inp.boxes[:2]:  # warm: one fresh render, one reuse render
        step(None, inp.objs_p, inp.hw, bx)[1].cpu()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(REPS):
            _, stat = step(None, inp.objs_p, inp.hw, inp.boxes[i % len(inp.boxes)])
        stat.cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per = _kernel_times(prof, REPS)
    busy_ms = sum(per.values()) / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    text = "; ".join(f"{k[:60]} {us:.1f} us" for k, us in top)
    print(f"[sweep-step] 1080x1920 B={batch} stat {stat_name}, reuse: {wall_ms / REPS:.3f} ms per "
          f"step host wall ({batch * REPS * 1e3 / wall_ms:.1f} canvases/s) under the "
          f"profiler; device busy {busy_ms:.3f} ms per step, idle share "
          f"{1 - busy_ms * REPS / wall_ms:.3f}; per step: {text} on {smi}")
    times = []
    for i in range(REPS):
        t0 = time.perf_counter()
        step(None, inp.objs_p, inp.hw, inp.boxes[i % len(inp.boxes)])[1].cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"[sweep-step] stat {stat_name} without the profiler, fenced each step: p50 "
          f"{statistics.median(times):.3f} ms, max {max(times):.3f} ms on {smi}")


def main() -> int:
    smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    device = torch.device("cuda", 0)
    for batch in (64, 256):
        profile_k2(batch, smi, device)
    reuse_vs_fresh(256, smi, device)
    host_costs(64, smi, device)
    for stat_name in ("luma", "fence"):
        sweep_step(256, stat_name, smi, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
