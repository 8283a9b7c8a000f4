#!/usr/bin/env python3
"""Where the hybrid compose's time goes, on one CUDA card.

    python -m tools.profile_k4             # K4 per launch, the hybrid step
    python -m tools.profile_k4 --anatomy   # K4's stage split (row 15)

Run from the root of a checkout (it reuses chip_smoke.py's device and build
phases, its hybrid batch: squarespace, 1080x1920, B=64, boxes from seed 0
plus an identity box and an edge box, and its bounds). Prints:

- K4's device time per call from torch.profiler, mean of ``REPS`` calls,
  split into its two launches (bounds, blend), in the unclamped and the
  clamped geometry and on the planar entry (row 2), with the bytes these
  inputs need (ops/roofline.py blend_bound: 4 per pixel of each live box,
  8 per plane pixel under a source pixel of alpha > 0), the rate they give
  and the bound at the card's HBM rate, and the source bytes the bounds
  launch reads (ops/roofline.py k4_scan_bytes) with the rate it reaches;
- the K4 wrapper's host steps on row 6's inputs, its whole host time and
  its CUDA-event time (tools/profile_k1.py ``wrapper_costs``);
- the clamped hybrid compose over ``REPS`` calls ending in one
  synchronize: host wall per call, device busy, idle share, and the device
  time of its largest kernels by name;
- with ``--anatomy``, instead: each stage variant of K4 (the counterpart of
  benchmarks/bisect_resize.py --anatomy) on the clamped producer's outputs,
  device time per launch (profiler, mean of ``REPS``) in ``ROUNDS`` rounds
  that take the variants in turn (median and spread) and CUDA-event median,
  beside its bound; then the split of K4's time into memory and coverage
  (``dma_only``), the placement (``no_roll``, ``no_shift``) and Pillow's
  alpha-over (``full`` - ``no_blend``, with whether it lies outside the two
  variants' spread). It fails if ``no_blend`` or ``dma_only`` runs under
  half its bytes' bound (bytes not moved);

each line with the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

import chip_smoke
from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.ops.roofline import blend_bound, k4_scan_bytes
from tools import profile_k1
from tools.profile_k2 import _kernel_times

REPS = 10
ROUNDS = 3


def k4_launch_us(prof, reps: int) -> dict:
    """K4's device time per call of each of its launches (bounds, blend)."""
    per = _kernel_times(prof, reps)
    return {label: sum(us for name, us in per.items() if key in name)
            for label, key in chip_smoke.K4_LAUNCHES}


def profile_k4(smi: str, device) -> None:
    _, _, canvases, objs, hw, boxes, env = chip_smoke.hybrid_inputs(device)
    forms = (("unclamped", ck._hybrid_producer, ck.window_blend),
             ("clamped", ck._hybrid_producer_clamped, ck.window_blend),
             ("planar (row 2)", ck._hybrid_producer_planar, ck.window_blend_planar))
    for name, producer, blend in forms:
        plane, src, meta = producer(canvases, objs, hw, boxes, env, "lanczos")
        blend(plane, src, meta)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                blend(plane, src, meta)
            torch.cuda.synchronize()
        parts = k4_launch_us(prof, REPS)
        us = sum(parts.values())
        if min(parts.values()) == 0:
            raise RuntimeError(f"the profiler saw no device time of a K4 launch: {parts}")
        shape = (plane.shape[0], *plane.shape[-2:])
        bnd = blend_bound(shape, src, meta)
        gbytes, scan = bnd["bound_gbytes"], k4_scan_bytes(shape, src, meta) / 1e9
        split = ", ".join(f"{label} {t:.1f} us ({100 * t / us:.0f}%)" for label, t in parts.items())
        print(f"[profile] K4 {name} plane {shape[1]}x{shape[2]} B={shape[0]} N={src.shape[1]} "
              f"source {src.shape[-2]}x{src.shape[-1]}: {us:.1f} us per call ({split}; mean of "
              f"{REPS}); the bounds launch scans {scan:.4f} GB at "
              f"{scan / (parts['bounds'] * 1e-6):.0f} GB/s; the bound's {gbytes:.4f} GB at "
              f"{gbytes / (us * 1e-6):.0f} GB/s, bound {1e3 * bnd['bound_ms']:.1f} us by "
              f"{bnd['bound_by']} on {smi}")
        del plane, src, meta
        torch.cuda.empty_cache()


def anatomy(smi: str, device) -> None:
    _, _, canvases, objs, hw, boxes, env = chip_smoke.hybrid_inputs(device)
    plane, src, meta = ck._hybrid_producer_clamped(canvases, objs, hw, boxes, env, "lanczos")
    metas = {v: ck._zero_columns(meta, ck.STAGE_ZEROED[v]) for v in ck.STAGE_VARIANTS}
    dev_us = {v: [] for v in ck.STAGE_VARIANTS}
    for _ in range(ROUNDS):  # the variants in turn, ROUNDS times: their spread
        for variant in ck.STAGE_VARIANTS:
            # the variant's launch on its meta, made out of the timed loop
            switch = "full" if variant in ck.STAGE_BLENDS else "no_blend"
            work = plane.clone()
            ck.window_blend_stage(work, src, metas[variant], switch)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(REPS):
                    ck.window_blend_stage(work, src, metas[variant], switch)
                torch.cuda.synchronize()
            dev_us[variant].append(sum(k4_launch_us(prof, REPS).values()))
    events = chip_smoke.stage_split(plane, src, meta, REPS)
    med = {v: statistics.median(t) for v, t in dev_us.items()}
    spread = {v: max(t) - min(t) for v, t in dev_us.items()}
    for variant in ck.STAGE_VARIANTS:
        bnd = blend_bound(plane.shape, src, metas[variant],
                                     blends=variant in ck.STAGE_BLENDS)
        if variant not in ck.STAGE_BLENDS and min(dev_us[variant]) < 500 * bnd["bound_ms"]:
            raise RuntimeError(f"{variant} ran {min(dev_us[variant]):.1f} us, under half its "
                               f"bound {1e3 * bnd['bound_ms']:.1f} us: its bytes did not move")
        rounds = ", ".join(f"{t:.1f}" for t in dev_us[variant])
        print(f"[anatomy] {variant}: {med[variant]:.1f} us per launch (profiler, median of "
              f"{ROUNDS} rounds of {REPS}: {rounds}; spread {spread[variant]:.1f}), "
              f"{1e3 * events[variant]:.1f} us (CUDA-event median); bound "
              f"{1e3 * bnd['bound_ms']:.1f} us ({bnd['bound_gbytes']:.4f} GB) on {smi}")
    full, alpha = med["full"], med["full"] - med["no_blend"]
    resolved = abs(alpha) > spread["full"] + spread["no_blend"]
    print(f"[anatomy] K4 (full) {full:.1f} us; memory and coverage (dma_only) "
          f"{med['dma_only']:.1f} us ({100 * med['dma_only'] / full:.1f}%); placement "
          f"(no_blend - dma_only) {med['no_blend'] - med['dma_only']:.1f} us; alpha-over "
          f"(full - no_blend) {alpha:.1f} us ({100 * alpha / full:.1f}%), "
          f"{'outside' if resolved else 'within'} the two variants' spread "
          f"({spread['full'] + spread['no_blend']:.1f} us); no_roll {med['no_roll']:.1f} us, "
          f"no_shift {med['no_shift']:.1f} us on {smi}")


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
    k4_ms = sum(v for k, v in per.items() if "k4_" in k) / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    text = "; ".join(f"{k[:70]} {us:.1f} us" for k, us in top)
    print(f"[hybrid-step] clamped compose 1080x1920 B={canvases.shape[0]}: "
          f"{wall_ms / REPS:.3f} ms per call host wall under the profiler; device busy "
          f"{busy_ms:.3f} ms (K4 {k4_ms:.3f} ms, {100 * k4_ms / busy_ms:.1f}%), idle share "
          f"{1 - busy_ms * REPS / wall_ms:.3f}; {len(per)} kernels by name, largest: "
          f"{text} on {smi}")


def host_costs(smi: str, device) -> None:
    """The K4 wrapper's host steps on row 6's inputs (``window_blend``)."""
    _, _, canvases, objs, hw, boxes, env = chip_smoke.hybrid_inputs(device)
    plane, src, meta = ck._hybrid_producer_clamped(canvases, objs, hw, boxes, env, "lanczos")
    B, N, mh = src.shape[0], src.shape[1], src.shape[2]
    nbytes = ck._k4_scratch_bytes(B, N, mh)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=device)
    fn = ck._kernel_entry("window_blend_launch")
    hp, wp, mw = plane.shape[1], plane.shape[2], src.shape[3]
    ptrs = (plane.data_ptr(), src.data_ptr(), meta.data_ptr(), scratch.data_ptr())
    stream = ck._stream_handle(device)
    steps = {
        "check": lambda: ck._check_blend_args(plane, src, meta),
        "grid check": lambda: ck._k4_grid_check(B, N, mh),
        "scratch": lambda: torch.empty(nbytes, dtype=torch.uint8, device=device),
        "device guard where needed": lambda: ck._device_guard(device).__enter__(),
        "stream (wrapper)": lambda: ck._stream_handle(device),
        "data_ptr x3": lambda: (plane.data_ptr(), src.data_ptr(), meta.data_ptr()),
    }
    launching = {"C entry (both launches)": lambda: fn(*ptrs, B, N, hp, wp, mh, mw, stream)}
    profile_k1.wrapper_costs(f"K4 wrapper steps, row 6 at 1080x1920 B={B}", steps,
                             lambda: ck.window_blend(plane, src, meta), smi, reps=2000,
                             launching=launching)


def main() -> int:
    smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    device = torch.device("cuda", 0)
    if "--anatomy" in sys.argv[1:]:
        anatomy(smi, device)
        return 0
    profile_k4(smi, device)
    host_costs(smi, device)
    hybrid_step(smi, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
