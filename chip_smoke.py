#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and nvcc.
Phases, each printing its own lines; any failure raises and the script
exits non-zero:

1. device: nvidia-smi name and power limit, the card's uncorrected ECC
   error counts (printed again after the traceback when a phase fails),
   torch/CUDA versions, Pillow; exits 1 at once when
   torch.cuda.is_available() is False;
2. build: compiles csrc/*.cu with nvcc (timed);
3. kernel vs plain version: K1 (ops/compose_kernels.fused_compose) against
   fused_compose_reference on the card, bit-exact (tolerance 0), at the
   CLI geometry (squarespace at 9:16, B=1) and the batched serving
   geometry (squarespace objects shared, 1080x1920, B=64, boxes from
   seed 0), with median CUDA-event times of both; then K1's launches
   (bounds, resample, blend) with ptxas's registers, shared memory and
   spills from the build log;
4. main path: the port CLI's main() with --device cuda --api fake
   --refine-iters 2 on squarespace 9:16 and audio_book 16:9. K1 launch
   counts are reset just before and read just after; every draft must
   equal the CPU plain engine's compose of its layout JSON and PIL's own
   LANCZOS resize + alpha_composite;
5. batched path (squarespace objects shared, 1080x1920): K2
   (ops/compose_kernels.fused_v3) against fused_v3_reference at B=64 with
   boxes from seed 0 and per-object static windows, and K3
   (restore_windows) against restore_windows_reference, both bit-exact
   (tolerance 0), with median CUDA-event times of both (and K2's launches,
   resample and blend, and K3's, with ptxas's figures; the windows' summed
   pixels beside their union, which K3 writes once); a 3-step reuse
   chain (K3 + K2 in place) equal to fresh renders; then the main path of
   the slice, throughput_sweep(kernel="pallas") at 1080p B=256 with
   warmup 1 and 5 reps, with the K2/K3 launch counts reset just before and
   read just after (both must be > 0), printing canvases/s; then
   kernel-table row 16, the run statistic at the benchmark cell's shape
   (B=256, the 1080-wide by 1920-high crop of a rendered padded plane):
   the luma kernel (ops/compose_kernels.packed_luma) == its plain version
   bit for bit, its launch count read around it, median CUDA-event times
   of both in turns beside its byte bound and the float16 path it replaced
   (library_ms), and the profiler's split of its two launches;
6. gradient path, kernel-table row 17 (the squarespace_uhd.score916 cell's
   shapes from its configuration and mix: 2160 wide x 3840 high, B=256,
   per-object output bounds at s0, the 12-level upscaled boxes from seed
   0), on the bundle's gradient axis and then on the other:
   make_gradient_render_step's fresh render, then 3 reuse steps with the
   launch counts reset just before and read just after (K3 3, K2 3 calls
   in 3 x ceil(B / chunk) chunk launches, luma 3) and K2's H-pass tally
   (compose_kernels.fused_v3_h_tally) read around them: fails where under
   95% of the resampled tiles took the column form; the last reuse step ==
   a fresh render; on that step's own inputs, K3's ramp form (ROW_RAMP or
   COL_RAMP) == restore_windows_reference and K2's MIXED instance (its
   growing axes' exact-argument tables, over its chunks) ==
   fused_v3_reference (in slices of 32 canvases), bit-exact, with median
   CUDA-event times of the kernels beside their bounds (K2 on the bundle's
   axis), the plain versions' times, and ptxas's figures of the instances;
   then [campaign], the campaign_uhd.sweep4x64 cell's shapes (its
   configuration and mix: B=64, canvas b bundle b % 2's own planar cutouts
   in 4 slots, audio_book's fourth empty, and its own gradient line; the
   four ratios' steps with the driver's bounds and boxes from seed 0): each
   ratio's fresh render, then 3 rounds of reuse steps, the ratios in turn,
   with the launch counts reset just before and read just after (K3's line
   form on every reuse step, every K2 chunk on per-canvas objects), with
   K2's H-pass tally around them beside ptxas's figures of both
   v3_resample instances; on each
   ratio's last reuse step the plane == a fresh render, the empty slots'
   windows lie past the plane and walk no tile, and K3's line form ==
   restore_windows_reference and K2 == fused_v3_reference (slices of 32
   canvases with their own objects) on the card's own inputs, bit-exact,
   each timed beside its bound; K3's line form on the other axis too, and
   ptxas's figures of both line-form instances;
7. hybrid path (squarespace, 1080x1920, B=64, boxes from seed 0 plus an
   identity box and the edge box of benchmarks/validate_hw.py:100): for
   each clamped x pipelined form of composite_batch_hybrid_packed, K4
   (ops/compose_kernels.window_blend) against window_blend_reference on
   that form's producer outputs, bit-exact, with median CUDA-event times
   of both and of the producer, and on a line of its own the source bytes
   K4's bounds launch reads beside the bound; then the form itself, with
   the K4 launch
   count reset just before and read just after (must be > 0), equal to
   the port's composite_batch on the card; K4's two launches (bounds,
   blend) with ptxas's figures; the packed_out plane's bytes
   equal the u8 output; 4 canvases within 2/255 of PIL's own LANCZOS
   resize + alpha_composite;
8. ops path (the hybrid batch): for kernel-table rows 7, 8, 9 (the
   clamped producer), 11 (row-baked), 4 (window-aligned) and 2 (planar),
   the K4 entry against its plain version on that row's producer outputs,
   bit-exact, with median CUDA-event times of both; then the row's public
   function (composite_batch_hybrid_packed's flag, composite_batch_aligned,
   composite_batch_hybrid) with its launch count reset just before and read
   just after (must be > 0), within 2/255 of composite_batch (the measured
   max is printed; 0 is expected); the bounds launch's bytes as in 7, and
   the packed and planar entries' launches with ptxas's figures. Row 1:
   composite_batch_pallas_host_tables
   at the CLI geometry and at 1080p B=64, K1 against its plain version on
   its arguments, and the output equal to composite_exact and PIL. Row 15:
   the five stage variants of K4 timed in turn (launch count read around
   them), each against its plain version, bit-exact;
9. variants path (the multi-ratio fused render, pipeline/fused.py, at a
   fleet user's size): run_fleet over squarespace and audio_book x 8 ratios
   at a 1920x1080 pixel budget, kernel "pallas", 20 reps, with the K2
   launch count reset just before and read just after (one launch per pass
   at least), its PNGs and boxes equal to the same fleet on the CPU, and
   its canvases/s per GPU and ms per pass; make_fused_render at V=64 (the
   8 ratios 8 times), solid and gradient, canvases, boxes and scales equal
   to the CPU run's (luma within rtol 1e-5), and K2 against its plain
   version on the inputs that step gave it, bit-exact, timed; both bundles'
   fused_multi_ratio_render on their own pixel budget, boxes equal to the
   host oracle and within 2/255 of PIL; the CLI with --variants on the card
   and the CPU, equal PNGs; then torch.profiler's split of a pass (K2, the
   device solve, the luma, the rest) and the solve's launches per pass, at
   V=8 and V=64;
10. serving (serving/server.py in process on the card, over HTTP, at the
   bundles' own sizes from their 970x250 backgrounds, e.g. 657x369 at
   9:16; N = 4 objects on squarespace, 3 on audio_book): /healthz names
   the card; /v1/render on both bundles x 9:16, 1:1, 16:9, 4:1 x solid,
   gradient, PNG and raw, with K1's count read around it (> 0), each image
   == the CPU service's (device "cpu") == PIL's own compose, tolerance 0;
   128 distinct layouts on one key from 16 client threads: fewer
   dispatches than requests (K1 with B > 1), every reply == its sequential
   CPU render; /v1/render_batch (buffered and NDJSON) and /v1/render_fleet
   at the 8 ratios of [variants] on both bundles, with K2's count read around them
   (> 0), canvases and boxes == the CPU service's, canvases within 2/255 of
   PIL (the max printed); then /v1/render's HTTP p50/p95 over 200
   sequential requests, the median X-Render-Timings split, requests/s and
   p50/p95 for 16 concurrent clients, render_batch's p50 at 8 ratios, and
   measure_device_ms for one request and a merge of 8; then both services
   are closed (ComposeService.close) and no drain worker is left alive;
11. agentic: run_workflow on the card with the fake client, squarespace
   9:16, 2 iterations, K1's count read around it (> 0), every draft and
   layout == the CPU run's, the drafts == PIL;
12. mesh (parallel/mesh.py on torch.distributed): two gloo ranks, both on
   cuda:0 (spawned; NCCL refuses two ranks on one card), then a world of
   one over nccl in this process (make_mesh with no torchrun world). Each
   rank runs make_sharded_solid_render at 1080x1920, B=64 in all
   (squarespace objects shared, boxes from seed 0), make_sharded_fused_render
   (pallas, masked) at the [variants] fleet size with 7 of the 8 ratios
   padded to 8 per bundle, run_fleet(mesh=) over both bundles x 8 ratios,
   and the sharded merge (sharded_compose_many) of 8 placement sets on
   serving's 657x369 canvas; K2's (K1's for the merge) count is reset just
   before each and read just after (> 0 in every rank), each output equals
   the single-GPU run byte for byte (luma within rtol 1e-5; rank 0 holds
   the fleet's PNGs and boxes against the single-GPU fleet's), and the
   step's and the all-reduce's ms are printed;
13. ui: the port's headless main app on the card (squarespace 9:16, fake
   client, 2 refinements) with K1's count read around it (> 0), its drafts
   == PIL; compat.compositor.composite on the card == PIL, K1 launched once;
   compat.macro_placement_test.main (the reference module's CLI, fake
   client, 1 refinement) with --device cuda (K1's count read around it,
   > 0) and --device cpu, drafts byte-equal to each other and == PIL;
14. install: the package copied (no bytecode) into a directory with no
   pyproject.toml above it, then in a subprocess whose cwd and PYTHONPATH
   hold only that copy and whose HOME is another temporary directory, one
   ops.compose.composite_exact on the card (K1, count read around it): the
   kernels build from the copy's csrc/ into that HOME's
   .cache/image_transformation_tpu_torch/kernels/, and the result == K1's
   plain version == PIL;
15. roofline (ops/roofline.py, ops/roofline_compute.py), under the port's
   PhaseWatchdog with a deadline per sub-phase (a stall prints one line
   naming it and exits 3): the bench workload, squarespace objects shared
   (planar), 1080x1920, B=256, boxes from seed 0, make_solid_render_step
   with stat "fence"; the step's bytes by term and operations by stage
   (counted once, outside the timed reps), device memory allocated
   around the step's construction and two steps (fresh, then reuse: K3 +
   K2) beside expected_live_hbm_bytes, the reuse and the fresh step's
   ms (median CUDA-event time of 20 reps after a warm-up, in turns),
   summarize and summarize_compute of each, and every kernel-table row's
   share of its bound (bound ms / measured ms) from the phases above. It
   fails when a share whose bytes do not fit in L2 reads above 1.05 (a
   count above the work) or when the live-memory prediction is under the
   measured peak by more than 10%;
16. one JSON line of kernel results (each with its bound from
   ops/roofline.py: the larger of the bytes it must move over the card's
   HBM rate and its resample multiply-adds on the int8 tensor cores, three
   limbs each, H100 peaks from NVIDIA's datasheet), the nvidia-smi line,
   and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "image_transformation_tpu_torch"
KERNEL_SOURCE = "image_transformation_tpu_torch/csrc/fused_compose.cu"
KERNEL_REPLACES = "image_transformation_tpu/ops/compose_pallas.py:2456"
V3_SOURCE = "image_transformation_tpu_torch/csrc/fused_v3.cu"
V3_REPLACES = "image_transformation_tpu/ops/compose_pallas.py:3081"
RESTORE_SOURCE = "image_transformation_tpu_torch/csrc/restore_windows.cu"
RESTORE_REPLACES = "image_transformation_tpu/ops/compose_pallas.py:3826"
BLEND_SOURCE = "image_transformation_tpu_torch/csrc/window_blend.cu"
BLEND_REPLACES = ("image_transformation_tpu/ops/compose_pallas.py:1210, :1457, :1581, "
                  ":1907, :1638, :1723, :1817, :2144, :1323 (kernel-table rows 3, 5, 6, "
                  "10, 7, 8, 9, 11, 4)")
PLANAR_REPLACES = "image_transformation_tpu/ops/compose_pallas.py:1029 (kernel-table row 2)"
STAGE_REPLACES = "benchmarks/bisect_resize.py:271 (kernel-table row 15)"
KERNEL_REPLACES_ROW1 = "image_transformation_tpu/ops/compose_pallas.py:829 (kernel-table row 1)"
LUMA_SOURCE = "image_transformation_tpu_torch/csrc/packed_luma.cu"
LUMA_REPLACES = ("none (kernel-table row 16): JAX leaves packed_luma, "
                 "image_transformation_tpu/ops/compose_pallas.py:2109, to XLA")
#: the luma's geometry: the benchmark cell's canvas, 1080 wide by 1920 high
LUMA_HW = (1920, 1080)
LIBRARY_NOTE = ("library_ms null: no single PyTorch call computes Pillow's fixed-point "
                "resample or alpha-over, or fills a set of per-placement windows")
#: (name, clamped, pipelined): the four forms K4 replaces, by kernel-table row
HYBRID_FORMS = (("row3", False, False), ("row5", False, True),
                ("row6", True, False), ("row10", True, True))
BATCH_HW = (1080, 1920)
HYBRID_B = 64
#: K1's and K2's launches per wrapper call: (label, a substring of the
#: kernel's mangled name in ptxas's report, and of its name in a profiler
#: trace); K2_PTXAS names the kernels the solid renders launch (the walk
#: over the live tiles)
K1_LAUNCHES = (("bounds", "k1_bounds"), ("resample", "k1_resample"), ("blend", "K1Rects"))
K2_LAUNCHES = (("resample", "v3_resample"), ("blend", "V3Rects"))
K2_PTXAS = (("resample", "v3_resampleILb0E"), ("blend", "box_blend_walk"))
#: K4's launches per call, by a substring of the kernel's name in a profiler
#: trace (any instantiation), and in ptxas's report (the instantiation the
#: packed and the planar entries launch on the smoke's aligned tensors)
K4_LAUNCHES = (("bounds", "k4_bounds"), ("blend", "k4_blend"))
K4_PTXAS = {"packed": (("bounds", "k4_boundsILb0ELb1E"), ("blend", "k4_blendILb0ELi4ELb1E")),
            "planar": (("bounds", "k4_boundsILb1ELb1E"), ("blend", "k4_blendILb1ELi4ELb1E"))}
K3_LAUNCHES = (("restore", "restore_kernelILi0E"),)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def ecc_line() -> str:
    """The card's uncorrected ECC error counts (since the driver loaded, and
    over its life) as nvidia-smi reports them. A device fault in torch's own
    kernels with the first count risen is the card's memory, not the code."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=ecc.errors.uncorrected.volatile.total,"
             "ecc.errors.uncorrected.volatile.sram.secded,"
             "ecc.errors.uncorrected.aggregate.total,ecc.errors.uncorrected.aggregate.sram",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"ECC counts unavailable ({e})"
    text = (out.stdout or out.stderr).strip().splitlines()
    return ("uncorrected ECC errors (volatile total, volatile SRAM SEC-DED, "
            f"aggregate total, aggregate SRAM): {text[0] if text else '?'}")


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs (after one
    warm-up run)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("[device] torch.cuda.is_available() is False: no card, no result",
              file=sys.stderr)
        sys.exit(1)
    if not PACKAGE.is_dir():
        print(f"[device] {PACKAGE} is missing: run from a checkout of the repo",
              file=sys.stderr)
        sys.exit(1)
    smi = smi_line()
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] {ecc_line()}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} cards {torch.cuda.device_count()} "
          f"kind {torch.cuda.get_device_name(0)}")
    try:
        import PIL

        print(f"[device] Pillow {PIL.__version__} imports")
    except ImportError as e:
        raise SystemExit(f"[device] Pillow does not import: {e}")
    return smi


def phase_build():
    from image_transformation_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    print(f"[build] {path.name}: nvcc {_build.last_build_seconds:.2f}s, "
          f"total {time.perf_counter() - t0:.2f}s")


def launch_text(launches, dynamic_smem) -> str:
    """Each launch of a wrapper call with ptxas's registers, shared memory
    (static, and dynamic as launched) and spills, from this process's build
    log (``phase_build``); a launch's key is a substring of the kernel's
    mangled name, or a tuple of substrings it holds all of."""
    from image_transformation_tpu_torch.ops import _build

    usage = _build.ptxas_usage(_build.last_build_report)
    parts = []
    for (label, key), dyn in zip(launches, dynamic_smem):
        keys = (key,) if isinstance(key, str) else key
        found = [u for name, u in usage.items() if all(k in name for k in keys)]
        if not found:
            parts.append(f"{label} (no ptxas report: the library was built before)")
            continue
        u = found[0]
        parts.append(f"{label} ({u['registers']} registers, smem {u['smem']} B static + "
                     f"{dyn} B dynamic, stack {u['stack']} B, spills {u['spill_stores']}/"
                     f"{u['spill_loads']} B)")
    return " -> ".join(parts)


def _geometry_inputs(bundle_dir: Path, canvas_hw, batch: int, seed: int, device):
    """Canvas [B, H, W, 4] (the bundle's solid median colour), shared
    objects [1, N, ph, pw, 4] and K1 tables for random downscale boxes."""
    import numpy as np
    import torch

    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.ops.background import synthesize_canvas
    from image_transformation_tpu_torch.ops.compose_kernels import fused_tables_prep
    from image_transformation_tpu_torch.parallel.sweep import random_downscale_boxes

    bundle = load_bundle(bundle_dir)
    arrays = bundle.to_arrays()
    H, W = canvas_hw
    bg = torch.from_numpy(np.asarray(bundle.background).copy()).to(device)
    base = synthesize_canvas(bg, W, H, "solid")
    canvas = base[None].expand(batch, H, W, 4).contiguous()
    rng = np.random.default_rng(seed)
    boxes = np.stack(
        [random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(batch)]
    )
    obj_hw = np.broadcast_to(arrays.obj_hw, (batch, *arrays.obj_hw.shape))
    pad = arrays.objects.shape[1:3]
    kh, kv, boxes_i32, flags = fused_tables_prep(obj_hw, boxes, (H, W), pad, pad)
    objects = torch.from_numpy(arrays.objects).to(device)[None].contiguous()
    tables = [torch.from_numpy(a).to(device) for a in (kh, kv, boxes_i32, flags)]
    return canvas, objects, tables


def phase_kernel(smi: str):
    import torch

    from image_transformation_tpu_torch.layout.canvas import compute_canvas_size
    from image_transformation_tpu_torch.ops.compose_kernels import (
        fused_compose,
        fused_compose_reference,
    )
    from image_transformation_tpu_torch.ops.roofline import k1_bound

    device = torch.device("cuda", 0)
    w9, h9 = compute_canvas_size((970, 250), "9:16", verbose=False)
    geometries = [
        ("cli_9x16_b1", (h9, w9), 1, 8, 20),
        ("serve_1080p_b64", (1080, 1920), 64, 4, 3),
    ]
    results = {}
    for name, hw, batch, k_reps, p_reps in geometries:
        canvas, objects, tables = _geometry_inputs(
            ROOT / "data" / "squarespace", hw, batch, 0, device
        )
        out_k = fused_compose(canvas.clone(), objects, *tables)
        out_p = fused_compose_reference(canvas.clone(), objects, *tables)
        torch.cuda.synchronize()
        err = int((out_k.to(torch.int32) - out_p.to(torch.int32)).abs().max())
        changed = int((out_k != canvas).any(dim=-1).sum())
        if not torch.equal(out_k, out_p):
            raise AssertionError(f"[kernel] {name}: K1 != plain version, max abs err {err}")
        if changed == 0:
            raise AssertionError(f"[kernel] {name}: K1 changed no pixel")
        work_k, work_p = canvas.clone(), canvas.clone()
        # in turns: plain, kernel, kernel, plain
        p1 = cuda_ms(lambda: fused_compose_reference(work_p, objects, *tables), p_reps)
        k1 = cuda_ms(lambda: fused_compose(work_k, objects, *tables), k_reps)
        k2 = cuda_ms(lambda: fused_compose(work_k, objects, *tables), k_reps)
        p2 = cuda_ms(lambda: fused_compose_reference(work_p, objects, *tables), p_reps)
        ms, plain_ms = min(k1, k2), min(p1, p2)
        n_obj, pad = objects.shape[1], objects.shape[2:4]
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             **k1_bound(canvas, objects, *tables))
        print(f"[kernel] {name}: canvas {hw[0]}x{hw[1]} B={batch} "
              f"N={objects.shape[1]} pad {objects.shape[2]}x{objects.shape[3]}: "
              f"K1 == plain (max abs err {err}, {changed} pixels composed); "
              f"K1 {ms:.3f} ms ({k1:.3f}, {k2:.3f}), plain {plain_ms:.3f} ms "
              f"({p1:.3f}, {p2:.3f}), {_bound_text(results[name])} on {smi}")
        del canvas, objects, tables, out_k, out_p, work_k, work_p
        torch.cuda.empty_cache()
    from image_transformation_tpu_torch.ops import compose_kernels as ck

    smem = ck.launch_smem("fused_compose", *pad, n_obj)
    print(f"[kernel] K1 launches per call: {launch_text(K1_LAUNCHES, smem)}")
    return results


def _pil_draft(bundle, canvas_png: Path, placements):
    """PIL's own compose: LANCZOS resize + alpha_composite, list order."""
    from PIL import Image

    return _pil_compose(bundle, Image.open(canvas_png).convert("RGBA"), placements)


def _pil_compose(bundle, canvas, placements):
    """PIL's own compose onto the RGBA ``canvas`` (in place, returned)."""
    from PIL import Image

    for p in placements:
        oid = int(p["object_id"])
        if oid not in bundle.objects:
            continue
        x1, y1, x2, y2 = (int(v) for v in p["box"])
        w, h = max(1, x2 - x1), max(1, y2 - y1)
        canvas.alpha_composite(
            bundle.objects[oid].resize((w, h), Image.LANCZOS), dest=(x1, y1)
        )
    return canvas


def phase_main_path():
    import numpy as np
    import torch
    from PIL import Image

    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.ops import compose_kernels
    from image_transformation_tpu_torch.pipeline.cli import main
    from image_transformation_tpu_torch.pipeline.engine import ComposeEngine

    runs = [("squarespace", "9:16"), ("audio_book", "16:9")]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        out_dirs = []
        compose_kernels.reset_launch_counts()
        for bundle_name, ratio in runs:
            out_dirs.append(main([
                "--bundle", str(ROOT / "data" / bundle_name), "--ratio", ratio,
                "--api", "fake", "--refine-iters", "2", "--device", "cuda",
                "--output-root", str(Path(tmp) / ratio.replace(":", "x")),
            ]))
        torch.cuda.synchronize()
        launches = dict(compose_kernels.LAUNCHES)

        n_drafts = 0
        for (bundle_name, ratio), base in zip(runs, out_dirs):
            if not (base / "time_log.txt").is_file():
                raise AssertionError(f"[main] {base}: no time_log.txt")
            drafts = sorted(base.glob("iteration_*/final_product/draft_macro_iter_*.png"))
            if not drafts:
                raise AssertionError(f"[main] {base}: no drafts composed")
            bundle = load_bundle(ROOT / "data" / bundle_name)
            canvas_png = base / "iteration_00" / "vlm_input_image" / "canvas.png"
            canvas = np.asarray(Image.open(canvas_png).convert("RGBA"))
            engine = ComposeEngine(bundle.to_arrays(), canvas, torch.device("cpu"))
            for draft in drafts:
                it = draft.parent.parent
                idx = draft.stem.rsplit("_", 1)[1]
                layout = json.loads(
                    (it / "layout_json" / f"layout_macro_iter_{idx}.json").read_text()
                )
                got = np.asarray(Image.open(draft).convert("RGBA"))
                plain = engine.compose(layout["placements"]).numpy()
                pil = np.asarray(_pil_draft(bundle, canvas_png, layout["placements"]))
                if not np.array_equal(got, plain):
                    raise AssertionError(f"[main] {draft}: differs from the CPU plain engine")
                if not np.array_equal(got, pil):
                    raise AssertionError(f"[main] {draft}: differs from PIL")
                n_drafts += 1
                print(f"[main] {bundle_name} {ratio} {draft.name}: {got.shape[1]}x{got.shape[0]} "
                      "== CPU plain engine == PIL")
            steps = (base / "time_log.txt").read_text().strip().replace("\n", "; ")
            print(f"[main] {bundle_name} {ratio} time_log: {steps}")
        if launches["fused_compose"] < n_drafts:
            raise AssertionError(
                f"[main] K1 launched {launches['fused_compose']} times for {n_drafts} drafts"
            )
        print(f"[main] K1 launches during the CLI runs: {launches['fused_compose']} "
              f"({n_drafts} drafts)")
    return launches


def _max_abs_err(a, b) -> int:
    """Largest per-byte difference of two packed int32 planes."""
    import torch

    from image_transformation_tpu_torch.ops.compose_kernels import packed_to_u8

    return int((packed_to_u8(a).to(torch.int32) - packed_to_u8(b).to(torch.int32))
               .abs().max())


def _in_turns(kernel, plain, k_reps, p_reps):
    """Median CUDA-event times, in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, p_reps)
    k1 = cuda_ms(kernel, k_reps)
    k2 = cuda_ms(kernel, k_reps)
    p2 = cuda_ms(plain, p_reps)
    return min(k1, k2), min(p1, p2), (k1, k2, p1, p2)


def _bound_text(r: dict) -> str:
    return (f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bound_gbytes']:.4f} GB, "
            f"{r['bound_gmacs']:.3f} G multiply-adds; scalar diagnostic {r['scalar_ms']:.4f} ms"
            f"{', L2-resident' if r['l2_resident'] else ''})")


def _k2_walk(meta, pad, env, device):
    """K2's grids for one call over ``meta``'s batch, from the C entry
    (``fused_v3_grid``, per chunk), beside the blocks a grid over the
    envelope would take and the live tiles (a plain count over the meta,
    after a synchronise): (dict, text)."""
    import torch

    from image_transformation_tpu_torch.ops import compose_kernels as ck

    torch.cuda.synchronize()
    B, N = meta.shape[:2]
    chunk = ck._v3_chunk(B, N, *env, mixed=env[0] > pad[0] or env[1] > pad[1])
    grids = [ck._v3_grid(min(chunk, B - b0), N, pad, env, device)
             for b0 in range(0, B, chunk)]
    r = dict(live_tiles=int(ck._v3_live_tiles(meta.cpu(), env).sum()),
             envelope_blocks=B * N * -(-env[0] // 32) * -(-env[1] // 32),
             resample_blocks=sum(g.resample_blocks for g in grids),
             blend_blocks=sum(g.blend_blocks for g in grids),
             walks=sum(g.resample_launches for g in grids), chunks=len(grids),
             resample_resident=grids[0].resample_resident,
             blend_resident=grids[0].blend_resident,
             smem=(grids[0].resample_smem, grids[0].blend_smem))
    text = (f"K2 grid a call: {r['chunks']} chunks in {r['walks']} resample launches over the "
            f"live tiles; blocks launched: resample {r['resample_blocks']:,}, blend "
            f"{r['blend_blocks']:,} (a grid over the envelope: {r['envelope_blocks']:,} each) "
            f"for {r['live_tiles']:,} live tiles; "
            f"resident blocks an SM: resample {r['resample_resident']}, blend "
            f"{r['blend_resident']} ({torch.cuda.get_device_properties(device).multi_processor_count}"
            f" SMs)")
    return r, text


def _scan_text(plane_shape, src, meta, bnd) -> str:
    """The bytes K4's bounds launch reads beside the launch's bound (not a
    measurement: counted from the inputs)."""
    import torch

    from image_transformation_tpu_torch.ops.roofline import hbm_peak_gbps, k4_scan_bytes

    scan = k4_scan_bytes((plane_shape[0], *plane_shape[-2:]), src, meta)
    peak = hbm_peak_gbps(torch.cuda.get_device_name())
    return (f"K4 bounds launch reads {scan / 1e9:.4f} GB of sources "
            f"({scan / peak / 1e6:.4f} ms at {peak:.0f} GB/s) beside the call's bound "
            f"{bnd['bound_gbytes']:.4f} GB ({bnd['bound_ms']:.4f} ms): with JAX's signature the "
            f"live boxes are known only after that scan")


def phase_batched(smi: str):
    import numpy as np
    import torch

    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.ops import compose_kernels as ck
    from image_transformation_tpu_torch.ops.roofline import k2_bound, k3_bound
    from image_transformation_tpu_torch.parallel import throughput_sweep
    from image_transformation_tpu_torch.parallel.sweep import random_downscale_boxes

    device = torch.device("cuda", 0)
    bundle = load_bundle(ROOT / "data" / "squarespace")
    arrays = bundle.to_arrays()
    H, W = BATCH_HW
    B = 64
    N = arrays.obj_hw.shape[0]
    static = tuple(tuple(int(v) for v in row) for row in arrays.obj_hw)
    objs_p = ck.planarize_objects(torch.from_numpy(arrays.objects).to(device)[None])
    hw = torch.from_numpy(np.broadcast_to(arrays.obj_hw, (B, N, 2)).copy()).to(device)

    def boxes(seed):
        rng = np.random.default_rng(seed)
        return torch.from_numpy(np.stack(
            [random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(B)]
        )).to(device)

    bg = ck.pack_rgba_scalar((128, 128, 128, 255))
    results = {}

    # K2 vs its plain version, on the inputs render_solid_fused_v3_program gives it
    geo = ck.render_geometry((H, W), objs_p.shape[3:], N, static, pipelined=True)
    meta, env, (hp, wp) = geo.meta(hw, boxes(0)), geo.envelope, geo.pad
    base = torch.full((B, hp, wp), bg, dtype=torch.int32, device=device)
    out_k = ck.fused_v3(base.clone(), objs_p, meta, env)
    out_p = ck.fused_v3_reference(base.clone(), objs_p, meta, env)
    torch.cuda.synchronize()
    err = _max_abs_err(out_k, out_p)
    changed = int((out_k != base).sum())
    if not torch.equal(out_k, out_p):
        raise AssertionError(f"[batched] K2 != plain version, max abs err {err}")
    if changed == 0:
        raise AssertionError("[batched] K2 changed no pixel")
    work_k, work_p = base.clone(), base.clone()
    ms, plain_ms, raw = _in_turns(
        lambda: ck.fused_v3(work_k, objs_p, meta, env),
        lambda: ck.fused_v3_reference(work_p, objs_p, meta, env), 5, 2)
    results["fused_v3"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               **k2_bound(base, objs_p, meta, env))
    print(f"[batched] K2 canvas {H}x{W} (plane {hp}x{wp}) B={B} N={N} shared objects, "
          f"static windows: K2 == plain (max abs err {err}, {changed} pixels changed); "
          f"K2 {ms:.3f} ms ({raw[0]:.3f}, {raw[1]:.3f}), plain {plain_ms:.3f} ms "
          f"({raw[2]:.3f}, {raw[3]:.3f}), {_bound_text(results['fused_v3'])} on {smi}")
    walk, walk_text = _k2_walk(meta, tuple(objs_p.shape[3:]), env, device)
    results["fused_v3"]["walk"] = walk
    print(f"[batched] {walk_text}")
    print(f"[batched] K2 launches per call: {launch_text(K2_PTXAS, walk['smem'])}")
    del work_k, work_p

    # K3 vs its plain version: restore the windows of that render
    static_win = geo.windows
    origins = meta[..., :2].contiguous()
    extents = static_win
    got = ck.restore_windows(out_k.clone(), origins, extents, bg)
    want = ck.restore_windows_reference(out_k.clone(), origins, extents, bg)
    torch.cuda.synchronize()
    err = _max_abs_err(got, want)
    if not torch.equal(got, want):
        raise AssertionError(f"[batched] K3 != plain version, max abs err {err}")
    if not torch.equal(got, base):
        raise AssertionError("[batched] restoring the windows left pixels of the render")
    work_k, work_p = out_k.clone(), out_k.clone()
    ms, plain_ms, raw = _in_turns(
        lambda: ck.restore_windows(work_k, origins, extents, bg),
        lambda: ck.restore_windows_reference(work_p, origins, extents, bg), 10, 3)
    k3b = k3_bound(base, origins, extents)
    results["restore_windows"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **k3b)
    print(f"[batched] K3 B={B} N={N} per-object windows {list(static_win)}: K3 == plain "
          f"(max abs err {err}) and leaves the solid plane; K3 {ms:.3f} ms "
          f"({raw[0]:.3f}, {raw[1]:.3f}), plain {plain_ms:.3f} ms "
          f"({raw[2]:.3f}, {raw[3]:.3f}), {_bound_text(results['restore_windows'])} on {smi}")
    print(f"[batched] K3 windows: {k3b['summed_px']} pixels summed over the windows, "
          f"{k3b['union_px']} in their union per canvas ({k3b['summed_px'] / k3b['union_px']:.3f}"
          f"x: the overlap a per-window fill writes twice); K3 launches per call: "
          f"{launch_text(K3_LAUNCHES, ck.launch_smem('restore_windows', 0, 0, N))}")
    del out_k, out_p, got, want, work_k, work_p, base

    # a 3-step reuse chain equals fresh renders
    sets = [boxes(seed) for seed in range(4)]
    plane = ck.render_solid_fused_v3_program(
        objs_p, hw, sets[0], (H, W), bg, pipelined=True, static_obj_hw=static)
    for step_i, (prev, cur) in enumerate(zip(sets, sets[1:]), start=1):
        plane = ck.render_solid_fused_v3_reuse_program(
            plane, prev, objs_p, hw, cur, (H, W), bg, static_obj_hw=static,
            pipelined=True)
        fresh = ck.render_solid_fused_v3_program(
            objs_p, hw, cur, (H, W), bg, pipelined=True, static_obj_hw=static)
        if not torch.equal(plane, fresh):
            raise AssertionError(f"[batched] reuse step {step_i} != a fresh render")
    print("[batched] reuse chain: 3 reuse steps (K3 + K2 in place) == fresh renders")
    del plane, fresh
    torch.cuda.empty_cache()

    # the slice's main path: the throughput sweep on the solid render step
    ck.reset_launch_counts()
    sweep = throughput_sweep(
        [bundle], ["16:9"], batch_per_ratio=256, pixel_budget_size=(W, H),
        kernel="pallas", warmup=1, reps=5, device="cuda",
    )
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    for name in ("fused_v3", "fused_v3_walks", "restore_windows", "packed_luma"):
        if launches[name] <= 0:
            raise AssertionError(f"[batched] the sweep launched {name} {launches[name]} times")
    r = sweep["ratios"]["16:9"]
    if tuple(r["canvas"]) != (W, H) or not r["canvases_per_sec"] > 0:
        raise AssertionError(f"[batched] unexpected sweep result {sweep}")
    print(f"[batched] throughput_sweep squarespace 16:9 {r['canvas'][0]}x{r['canvas'][1]} "
          f"B={r['batch']} pallas warmup 1 reps 5: {r['canvases_per_sec']:.1f} canvases/s "
          f"({r['seconds_per_batch'] * 1e3:.3f} ms per batch); launches K2 "
          f"{launches['fused_v3']} ({launches['fused_v3_walks']} resample walks), K3 "
          f"{launches['restore_windows']}, luma {launches['packed_luma']} on {smi}")
    return results, launches, sweep


def phase_luma(smi: str) -> dict:
    """Kernel-table row 16: the luma kernel at the benchmark cell's shape."""
    import numpy as np
    import torch

    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.ops import compose_kernels as ck
    from image_transformation_tpu_torch.ops.roofline import bound
    from image_transformation_tpu_torch.parallel.sweep import (
        make_solid_render_step,
        random_downscale_boxes,
    )

    device = torch.device("cuda", 0)
    arrays = load_bundle(ROOT / "data" / "squarespace").to_arrays()
    H, W = LUMA_HW
    B, N = ROOFLINE_B, arrays.obj_hw.shape[0]
    static = tuple(tuple(int(v) for v in row) for row in arrays.obj_hw)
    rng = np.random.default_rng(0)
    boxes = torch.from_numpy(np.stack(
        [random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(B)])).to(device)
    hw = torch.from_numpy(np.broadcast_to(arrays.obj_hw, (B, N, 2)).copy()).to(device)
    objs_p = ck.planarize_objects(torch.from_numpy(arrays.objects).to(device)[None])
    step = make_solid_render_step((H, W), arrays.objects.shape[1:3], static_obj_hw=static,
                                  stat="fence", device="cuda")
    plane, _ = step(None, objs_p, hw, boxes)
    crop = plane[:, :H, :W]
    ck.reset_launch_counts()
    got = ck.packed_luma(crop)
    want = ck.packed_luma_reference(crop)
    torch.cuda.synchronize()
    launches = ck.LAUNCHES["packed_luma"]
    if launches != 1:
        raise AssertionError(f"[luma] one call launched the kernel {launches} times")
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"[luma] kernel != plain version, max abs err {err}")
    rgb = crop.view(torch.uint8).unflatten(-1, (W, 4))[..., :3]
    ms, plain_ms, raw = _in_turns(lambda: ck.packed_luma(crop),
                                  lambda: ck.packed_luma_reference(crop), 50, 3)
    library_ms = cuda_ms(lambda: rgb.to(torch.float16).sum(dim=(1, 2), dtype=torch.float32), 10)
    nbytes = B * (H * W * 4 + 4)  # one read of each crop, its float out
    res = {**bound(nbytes, 0, 0, torch.cuda.get_device_name(0)), "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "launches": launches}
    us, _, _ = _profiled(lambda: ck.packed_luma(crop), 20)
    split = ", ".join(f"{name[:40]} {t:.1f} us" for name, t in sorted(us.items(), key=lambda kv: -kv[1]))
    print(f"[luma] row 16 crop {H}x{W} of plane {tuple(plane.shape)} (row stride {crop.stride(1)}) "
          f"B={B}: kernel == plain (max abs err {err}); kernel {ms:.4f} ms ({raw[0]:.4f}, "
          f"{raw[1]:.4f}; {nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.3f} ms ({raw[2]:.3f}, "
          f"{raw[3]:.3f}), float16 path (library_ms) {library_ms:.3f} ms, {_bound_text(res)}, "
          f"share of the bound {res['bound_ms'] / ms:.4f} on {smi}")
    print(f"[luma] launches per call (profiler, per call): {split}")
    step.release()
    del plane, crop, rgb, step
    torch.cuda.empty_cache()
    return res


#: K2's MIXED instance (exact-argument tables on growing axes, built by its
#: table stage) and K3's ramp forms, by a substring of the kernel's mangled
#: name in ptxas's report
K2_MIXED_LAUNCHES = (("tables", "v3_tables"), ("resample", "v3_resampleILb1E"),
                     ("blend", "box_blend_walk"))
K3_RAMP_LAUNCHES = {True: (("restore", "restore_kernelILi1E"),),  # ROW_RAMP
                    False: (("restore", "restore_kernelILi2E"),)}  # COL_RAMP
#: the UHD cell's configuration and mix (squarespace_uhd.score916)
UHD_CONFIG = "bench_torch/configs/squarespace_uhd.json"
UHD_MIX = "bench_torch/mixes/score916.json"
#: canvases per slice of K2's plain version at the UHD shapes (its tables
#: for a whole batch of 256 would take tens of GB)
UHD_PLAIN_SLICE = 32
UHD_REUSE_STEPS = 3
#: the least share of K2's mixed-instance tiles whose H pass takes the column
#: form (``compose_kernels.fused_v3_h_tally``) at the UHD cell's shapes, where
#: every placement upscales 2.92-5.85x
H_COLUMNS_MIN = 0.95
#: the campaign cell's configuration and mix (campaign_uhd.sweep4x64)
CAMPAIGN_CONFIG = "bench_torch/configs/campaign_uhd.json"
CAMPAIGN_MIX = "bench_torch/mixes/sweep4x64.json"
#: K3's line forms (a gradient line per canvas), by a substring of the
#: kernel's mangled name in ptxas's report
K3_LINES_LAUNCHES = {True: (("restore", "restore_lines_kernelILi1E"),),  # ROW_RAMP
                     False: (("restore", "restore_lines_kernelILi2E"),)}  # COL_RAMP


class _CaptureReuse:
    """Wraps K3 and K2 as the reuse program calls them (compose_kernels'
    module names) and, on the last call armed, keeps the plane before K3,
    the plane before K2 and each one's other arguments, to hold both
    against their plain versions on the card's own inputs afterwards."""

    def __init__(self):
        self.armed = False
        self.k3 = self.k2 = None

    def __enter__(self):
        from image_transformation_tpu_torch.ops import compose_kernels as ck

        self._real = (ck.restore_windows, ck.fused_v3)
        restore, compose = self._real

        def restore_rec(plane, origins, extents, bg):
            if self.armed:
                self.k3 = (plane.clone(), origins.clone(), extents, bg)
            return restore(plane, origins, extents, bg)

        def compose_rec(plane, objs_p, meta, out_max_hw):
            if self.armed:
                self.k2 = (plane.clone(), objs_p, meta.clone(), out_max_hw)
            return compose(plane, objs_p, meta, out_max_hw)

        ck.restore_windows, ck.fused_v3 = restore_rec, compose_rec
        return self

    def __exit__(self, *exc):
        from image_transformation_tpu_torch.ops import compose_kernels as ck

        ck.restore_windows, ck.fused_v3 = self._real


def _canvas_err(a, b) -> int:
    """:func:`_max_abs_err` taken a canvas at a time, over the canvases that
    differ (at the UHD shapes a batch's widened copies would take ~70 GB)."""
    import torch

    return max((_max_abs_err(x, y) for x, y in zip(a, b) if not torch.equal(x, y)), default=0)


def _k2_bound_sliced(plane, objs_p, meta, env, per, resample_only=False):
    """``k2_bound`` (or ``k2_resample_bound``) of a batch whose plain
    version runs in slices of ``per`` canvases: bytes, multiply-adds and
    scalar time summed over the slices, shared objects read once and
    per-canvas objects ([B, N, ...]) each by its own slice."""
    from image_transformation_tpu_torch.ops.roofline import bound, k2_bound, k2_resample_bound

    own = objs_p.shape[0] > 1

    def objs(i):
        return objs_p[i:i + per] if own else objs_p

    parts = [k2_resample_bound(objs(i), meta[i:i + per], env) if resample_only
             else k2_bound(plane[i:i + per], objs(i), meta[i:i + per], env)
             for i in range(0, plane.shape[0], per)]
    shared = 0 if own else (len(parts) - 1) * objs_p.numel()
    nbytes = sum(r["bound_gbytes"] for r in parts) * 1e9 - shared
    out = bound(nbytes, sum(r["bound_gmacs"] for r in parts) * 1e9)
    out["scalar_ms"] = sum(r["scalar_ms"] for r in parts)
    return out


def _h_tally_text(before, after):
    """(share, text) of K2's mixed-instance tiles between two readings of
    ``compose_kernels.fused_v3_h_tally``: those whose H pass took the
    column form over all it resampled."""
    cols, total = after[0] - before[0], after[1] - before[1]
    share = cols / total if total else 0.0
    return share, (f"K2's H pass in the column form on {cols:,} of {total:,} resampled tiles "
                   f"({100 * share:.2f}%)")


def phase_gradient(smi: str):
    """Kernel-table rows 17 (K3's ramp forms) and 18 (K2's table stage) and
    K2's MIXED instance at the UHD cell's shapes: make_gradient_render_step
    at 2160 wide x 3840 high, B=256, the cell's per-object output bounds at
    s0 and its 12-level boxes (seed 0), once on the bundle's gradient axis
    and once on the other; on the bundle's axis K2, its table stage and its
    resample are timed apart (the profiler) beside their bounds."""
    import numpy as np
    import torch

    from bench_torch.drivers.score_up import level_sizes, scale_levels, up_pool
    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.ops import compose_kernels as ck
    from image_transformation_tpu_torch.ops.background import gradient_spec
    from image_transformation_tpu_torch.ops.roofline import k2_tables_bound, k3_bound
    from image_transformation_tpu_torch.parallel import make_gradient_render_step

    cfg = json.loads((ROOT / UHD_CONFIG).read_text())
    mix = json.loads((ROOT / UHD_MIX).read_text())
    device = torch.device("cuda", 0)
    bundle = load_bundle(ROOT / cfg["bundle"])
    arrays = bundle.to_arrays()
    (H, W), B = mix["canvas_hw"], mix["batch"]
    N = arrays.obj_hw.shape[0]
    sizes = level_sizes(arrays.obj_hw, scale_levels((H, W), cfg["original_wh"],
                                                    mix["scale_levels"], mix["scale_range"]))
    bounds = tuple(tuple(int(v) for v in row) for row in sizes.max(axis=1))
    envelope = (max(h for h, _ in bounds), max(w for _, w in bounds))  # as the step takes it
    pool = torch.from_numpy(up_pool(np.random.default_rng(0), sizes, (H, W),
                                    UHD_REUSE_STEPS + 1, B)).to(device)
    objs_p = ck.planarize_objects(torch.from_numpy(arrays.objects[None]).to(device))
    hw = torch.from_numpy(np.broadcast_to(arrays.obj_hw, (B, N, 2)).copy()).to(device)
    c1, c2, bundle_axis = gradient_spec(
        torch.from_numpy(np.asarray(bundle.background, np.uint8).copy()).to(device))
    results, counts = {}, {}
    for horizontal in (bundle_axis, not bundle_axis):
        axis = "horizontal" if horizontal else "vertical"
        tag = f"[gradient] {axis}" + (" (the bundle's axis)" if horizontal == bundle_axis else "")
        step = make_gradient_render_step((H, W), bounds, (c1, c2, horizontal), device="cuda")
        step(None, objs_p, hw, pool[0])  # the fresh render
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        tally = ck.fused_v3_h_tally(device)
        with _CaptureReuse() as cap:
            for i in range(1, UHD_REUSE_STEPS + 1):
                cap.armed = i == UHD_REUSE_STEPS
                plane, _ = step(None, objs_p, hw, pool[i])
        torch.cuda.synchronize()
        h_share, h_text = _h_tally_text(tally, ck.fused_v3_h_tally(device))
        print(f"{tag} {UHD_REUSE_STEPS} reuse steps: {h_text}")
        if h_share < H_COLUMNS_MIN:
            raise AssertionError(f"{tag} {h_text}, under {100 * H_COLUMNS_MIN:.0f}%")
        launches = dict(ck.LAUNCHES)
        pre_k3, origins, extents, ramp = cap.k3
        pre_k2, _, meta, env = cap.k2
        chunk = ck._v3_chunk(B, N, *env, mixed=True)
        want = {"restore_windows": UHD_REUSE_STEPS, "fused_v3": UHD_REUSE_STEPS,
                "fused_v3_chunks": UHD_REUSE_STEPS * -(-B // chunk),
                "fused_v3_tables": UHD_REUSE_STEPS * -(-B // chunk),
                "fused_v3_walks": UHD_REUSE_STEPS * -(-B // chunk),
                "packed_luma": UHD_REUSE_STEPS}
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"{tag} {UHD_REUSE_STEPS} reuse steps launched {launches}, "
                                 f"expected {want}")
        fresh = ck.render_fused_v3_program(objs_p, hw, pool[UHD_REUSE_STEPS], (H, W), ramp,
                                           envelope, pipelined=True, static_obj_hw=bounds)
        if not torch.equal(plane, fresh):
            raise AssertionError(f"{tag} reuse step {UHD_REUSE_STEPS} != a fresh render")
        del fresh

        # K3's ramp form == its plain version on the card's own input
        err = _canvas_err(ck.restore_windows_reference(pre_k3, origins, extents, ramp), pre_k2)
        if not torch.equal(pre_k3, pre_k2):
            raise AssertionError(f"{tag} K3 != plain version, max abs err {err}")
        del pre_k3
        work = pre_k2.clone()
        ms, plain_ms, raw = _in_turns(
            lambda: ck.restore_windows(work, origins, extents, ramp),
            lambda: ck.restore_windows_reference(work, origins, extents, ramp), 10, 2)
        del work
        k3b = k3_bound(pre_k2, origins, extents)
        r3 = results[f"restore_{axis}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **k3b)
        print(f"{tag} K3 ramp form B={B} N={N} plane {tuple(pre_k2.shape[1:])} windows "
              f"{list(extents)}: K3 == plain (max abs err {err}); K3 {ms:.4f} ms ({raw[0]:.4f}, "
              f"{raw[1]:.4f}), plain {plain_ms:.3f} ms ({raw[2]:.3f}, {raw[3]:.3f}), "
              f"{_bound_text(r3)}; {k3b['summed_px']} pixels summed over the windows, "
              f"{k3b['union_px']} in their union; launches per call: "
              f"{launch_text(K3_RAMP_LAUNCHES[horizontal], ck.launch_smem('restore_windows', 0, 0, N))}"
              f" on {smi}")

        # K2 (MIXED, chunked) == its plain version on the card's own input, by slices
        err, t0 = 0, time.perf_counter()
        for i in range(0, B, UHD_PLAIN_SLICE):
            part = ck.fused_v3_reference(pre_k2[i:i + UHD_PLAIN_SLICE].clone(), objs_p,
                                         meta[i:i + UHD_PLAIN_SLICE], env)
            err = max(err, _canvas_err(part, plane[i:i + UHD_PLAIN_SLICE]))
            if not torch.equal(part, plane[i:i + UHD_PLAIN_SLICE]):
                raise AssertionError(f"{tag} K2 != plain version on canvases {i}+, "
                                     f"max abs err {err}")
            del part
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        # the table stage alone == its plain version (every entry, the card's meta)
        pad = tuple(objs_p.shape[3:])
        tables = ck.fused_v3_tables(meta, pad, env)
        t0 = time.perf_counter()
        tables_ref = ck.fused_v3_tables_reference(meta, pad, env)
        torch.cuda.synchronize()
        tables_plain_ms = (time.perf_counter() - t0) * 1e3
        tables_diff = int((tables != tables_ref).sum())
        if tables_diff:
            raise AssertionError(f"{tag} K2's table stage != plain version in {tables_diff} "
                                 f"of {tables.numel()} values")
        del tables, tables_ref
        if axis == ("horizontal" if bundle_axis else "vertical"):
            work = pre_k2.clone()
            ms = cuda_ms(lambda: ck.fused_v3(work, objs_p, meta, env), 5)
            ms2 = cuda_ms(lambda: ck.fused_v3(work, objs_p, meta, env), 5)
            us, _, _ = _profiled(lambda: ck.fused_v3(work, objs_p, meta, env), 3)
            del work
            part_ms = {label: sum(t for name, t in us.items() if key in name) / 1e3
                       for label, key in (("tables", "v3_tables"), ("resample", "v3_resample"),
                                          ("blend", "box_blend"))}
            r2 = results["fused_v3"] = dict(
                max_abs_err=err, ms=min(ms, ms2), plain_ms=plain_ms, h_columns_share=h_share,
                **_k2_bound_sliced(pre_k2, objs_p, meta, env, UHD_PLAIN_SLICE))
            rr = results["fused_v3_resample"] = dict(
                max_abs_err=err, ms=part_ms["resample"], plain_ms=plain_ms,
                **_k2_bound_sliced(pre_k2, objs_p, meta, env, UHD_PLAIN_SLICE, True))
            rt = results["fused_v3_tables"] = dict(
                max_abs_err=0, ms=part_ms["tables"], plain_ms=tables_plain_ms,
                **k2_tables_bound(meta, pad, env))
            walk, walk_text = _k2_walk(meta, pad, env, device)
            r2["walk"] = walk
            smem = walk["smem"]
            print(f"{tag} {walk_text}")
            print(f"{tag} K2 (MIXED: envelope {tuple(env)} past the pad "
                  f"{pad}) B={B} in {-(-B // chunk)} chunks of {chunk}: "
                  f"K2 == plain (max abs err {err}); K2 {r2['ms']:.4f} ms ({ms:.4f}, {ms2:.4f}), "
                  f"plain {plain_ms:.1f} ms (one pass, host clock, slices of {UHD_PLAIN_SLICE}), "
                  f"{_bound_text(r2)}; launches per chunk: "
                  f"{launch_text(K2_MIXED_LAUNCHES, (0, *smem))} on {smi}")
            print(f"{tag} K2's table stage == plain (every entry; plain {tables_plain_ms:.1f} ms, "
                  f"host clock): {rt['ms']:.4f} ms a call of {-(-B // chunk)} launches "
                  f"(profiler), {_bound_text(rt)}, share of the bound "
                  f"{rt['bound_ms'] / max(rt['ms'], 1e-9):.4f}")
            print(f"{tag} K2's MIXED resample: {rr['ms']:.4f} ms a call (profiler; blend "
                  f"{part_ms['blend']:.4f} ms), {_bound_text(rr)}, share of the bound "
                  f"{rr['bound_ms'] / max(rr['ms'], 1e-9):.4f}; plain version: K2's, above")
            print(f"{tag} ptxas: {launch_text(K2_PTXAS[:1], smem[:1])} (v3_resample<false>); "
                  f"{launch_text(K2_MIXED_LAUNCHES, (0, *smem))}")
        else:
            print(f"{tag} K2 (MIXED) == plain (max abs err {err}, {plain_ms:.1f} ms plain)")
        print(f"{tag} reuse chain: {UHD_REUSE_STEPS} reuse steps == a fresh render; launches "
              f"around them: K3 {launches['restore_windows']}, K2 {launches['fused_v3']} calls "
              f"in {launches['fused_v3_chunks']} chunks, fused_v3_tables "
              f"{launches['fused_v3_tables']}, fused_v3_walks {launches['fused_v3_walks']}, "
              f"fused_v3_own_objects {launches['fused_v3_own_objects']}, restore_windows_lines "
              f"{launches['restore_windows_lines']}, luma {launches['packed_luma']}")
        for k, v in launches.items():
            counts[k] = counts.get(k, 0) + v
        step.release()
        del plane, pre_k2, meta, origins, cap, step
        gc.collect()
        torch.cuda.empty_cache()
    return results, counts


def phase_campaign(smi: str):
    """Kernel-table row 17's line form and K2 on per-canvas objects at the
    campaign cell's shapes (campaign_uhd.sweep4x64): B=64, canvas b carrying
    bundle b % 2's own planar cutouts in 4 slots (audio_book's fourth empty)
    on its own gradient line, one make_gradient_render_step(reuse=True,
    stat="luma") a ratio with the driver's bounds and boxes (seed 0). Each
    ratio's fresh render, then 3 rounds of reuse steps, the four ratios in
    turn, the launch counts read around them; on each ratio's last reuse
    step the plane == a fresh render, the empty slots restore and walk
    nothing, and K3's line form and K2 == their plain versions on the
    card's own inputs, each timed beside its bound."""
    import numpy as np
    import torch

    from bench_torch.drivers.campaign import campaign_boxes, ratio_bounds
    from bench_torch.drivers.score_up import level_sizes, scale_levels
    from bench_torch.reference import canvas_size
    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.ops import compose_kernels as ck
    from image_transformation_tpu_torch.ops.background import gradient_spec
    from image_transformation_tpu_torch.ops.roofline import k3_bound
    from image_transformation_tpu_torch.parallel import make_gradient_render_step

    cfg = json.loads((ROOT / CAMPAIGN_CONFIG).read_text())
    mix = json.loads((ROOT / CAMPAIGN_MIX).read_text())
    device = torch.device("cuda", 0)
    bundles = [load_bundle(ROOT / path) for path in cfg["bundles"]]
    N = max(len(b.meta) for b in bundles)
    pad_hw = (max(m.height for b in bundles for m in b.meta.values()),
              max(m.width for b in bundles for m in b.meta.values()))
    arrays = [b.to_arrays(n_max=N, pad_hw=pad_hw) for b in bundles]
    budget, B, reuse = cfg["pixel_budget_wh"], mix["batch"], UHD_REUSE_STEPS
    levels = scale_levels(tuple(budget[::-1]), cfg["original_wh"], mix["scale_levels"],
                          mix["scale_range"])
    sizes = [level_sizes(a.obj_hw[:len(b.meta)], levels) for a, b in zip(arrays, bundles)]
    which = [b % len(bundles) for b in range(B)]
    objs_p = ck.planarize_objects(
        torch.from_numpy(np.stack([arrays[i].objects for i in which])).to(device))
    hw = torch.from_numpy(np.stack([arrays[i].obj_hw for i in which])).to(device)
    specs = [gradient_spec(torch.from_numpy(np.asarray(b.background, np.uint8).copy()).to(device))
             for b in bundles]
    c1, c2 = (np.array([specs[i][j] for i in which], np.uint8) for j in (0, 1))
    horizontal = [bool(specs[i][2]) for i in which]
    ratios = mix["ratios"]
    canvases = [canvas_size(tuple(budget), r)[::-1] for r in ratios]
    bounds = [ratio_bounds(sizes, N, c) for c in canvases]
    rng = np.random.default_rng(0)
    pools = [torch.from_numpy(np.stack([campaign_boxes(rng, sizes, N, c, B)
                                        for _ in range(reuse + 1)])).to(device) for c in canvases]
    steps = [make_gradient_render_step(c, bnd, (c1, c2, horizontal), reuse=True, stat="luma",
                                       device="cuda") for c, bnd in zip(canvases, bounds)]
    for step, pool in zip(steps, pools):  # the fresh renders
        step(None, objs_p, hw, pool[0])
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    tally = ck.fused_v3_h_tally(device)
    got = []
    with _CaptureReuse() as cap:
        for i in range(1, reuse + 1):
            for step, pool in zip(steps, pools):
                cap.armed = i == reuse
                plane, _ = step(None, objs_p, hw, pool[i])
                if cap.armed:
                    got.append((plane, cap.k3, cap.k2))
    torch.cuda.synchronize()
    h_share, h_text = _h_tally_text(tally, ck.fused_v3_h_tally(device))
    launches = dict(ck.LAUNCHES)
    pad = tuple(objs_p.shape[3:])
    mixed = [env[0] > pad[0] or env[1] > pad[1] for _, _, (_, _, _, env) in got]
    chunks = [-(-B // ck._v3_chunk(B, N, *env, mixed=m))
              for (_, _, (_, _, _, env)), m in zip(got, mixed)]
    R = len(ratios)
    want = {"restore_windows": reuse * R, "restore_windows_lines": reuse * R,
            "fused_v3": reuse * R, "fused_v3_chunks": reuse * sum(chunks),
            "fused_v3_own_objects": reuse * sum(chunks),
            "fused_v3_tables": reuse * sum(c for c, m in zip(chunks, mixed) if m),
            "packed_luma": reuse * R}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"[campaign] {reuse} rounds of reuse steps over {R} ratios "
                             f"launched {launches}, expected {want}")
    print(f"[campaign] B={B} N={N} (bundle b % 2: {[len(b.meta) for b in bundles]} cutouts, "
          f"planar objects {tuple(objs_p.shape)}, one each canvas), ratios {ratios}: "
          f"{reuse} rounds of reuse steps, the ratios in turn, launched K3 "
          f"{launches['restore_windows']} (restore_windows_lines "
          f"{launches['restore_windows_lines']}), K2 {launches['fused_v3']} calls in "
          f"{launches['fused_v3_chunks']} chunks (fused_v3_own_objects "
          f"{launches['fused_v3_own_objects']}, fused_v3_tables {launches['fused_v3_tables']}, "
          f"fused_v3_walks {launches['fused_v3_walks']}), luma {launches['packed_luma']}")
    k2_smem = ck._v3_grid(B, N, pad, got[0][2][3], device).resample_smem
    print(f"[campaign] {reuse} rounds of reuse steps: {h_text}; ptxas: "
          f"{launch_text(K2_PTXAS[:1], (k2_smem,))} (v3_resample<false>); "
          f"{launch_text(K2_MIXED_LAUNCHES[1:2], (k2_smem,))} (v3_resample<true>)")
    smem = ck.launch_smem("restore_windows", 0, 0, N)
    forms = [((f"{kind} {fill}", key),) for kind, table in (("lines", K3_LINES_LAUNCHES),
                                                             ("shared line", K3_RAMP_LAUNCHES))
             for fill, ((_, key),) in (("ROW_RAMP", table[True]), ("COL_RAMP", table[False]))]
    print(f"[campaign] K3's ramp instances, ptxas: "
          f"{'; '.join(launch_text(form, smem) for form in forms)}")
    empty = (hw == 0).all(-1).cpu()  # [B, N]: the slots of size 0
    results = {}
    for r, (ratio, (H, W)) in enumerate(zip(ratios, canvases)):
        tag = f"[campaign] {ratio} {W}x{H}"
        plane, (pre_k3, origins, extents, ramp), (pre_k2, _, meta, env) = got[r]
        got[r] = None
        hp, wp = plane.shape[1:]
        if tuple(ramp.values.shape) != (B, wp if ramp.horizontal else hp):
            raise AssertionError(f"{tag} the ramp is {tuple(ramp.values.shape)}, not a line a canvas")
        # the empty slots: windows past the plane, no live tile, no table entry
        tiles = ck._v3_live_tiles(meta.cpu(), env)
        past = origins.cpu()[empty]
        if not (bool((past == torch.tensor([wp, hp], dtype=past.dtype)).all())
                and int(tiles[empty].sum()) == 0 and int(tiles[~empty].min()) > 0):
            raise AssertionError(f"{tag} an empty slot has a window on the plane or live tiles")
        fresh = ck.render_fused_v3_program(objs_p, hw, pools[r][reuse], (H, W), ramp,
                                           (max(h for h, _ in bounds[r]),
                                            max(w for _, w in bounds[r])),
                                           pipelined=True, static_obj_hw=bounds[r])
        if not torch.equal(plane, fresh):
            raise AssertionError(f"{tag} reuse step {reuse} != a fresh render")
        del fresh

        # K3's line form == its plain version on the card's own input, timed
        err = _canvas_err(ck.restore_windows_reference(pre_k3, origins, extents, ramp), pre_k2)
        if not torch.equal(pre_k3, pre_k2):
            raise AssertionError(f"{tag} K3's line form != plain version, max abs err {err}")
        del pre_k3
        axes = [(ramp, "horizontal" if ramp.horizontal else "vertical")]
        if r == 0:  # and along the other axis, on the same windows
            other = ck.gradient_ramp(c1, c2, not ramp.horizontal, (H, W), (hp, wp), device)
            axes.append((other, "vertical" if ramp.horizontal else "horizontal"))
        k3b = k3_bound(pre_k2, origins, extents)
        for line, axis in axes:
            if line is not ramp:
                want_k3 = ck.restore_windows_reference(pre_k2.clone(), origins, extents, line)
                got_k3 = ck.restore_windows(pre_k2.clone(), origins, extents, line)
                err = _canvas_err(got_k3, want_k3)
                if not torch.equal(got_k3, want_k3):
                    raise AssertionError(f"{tag} K3's {axis} line form != plain version, "
                                         f"max abs err {err}")
                del want_k3, got_k3
            work = pre_k2.clone()
            ms, plain_ms, raw = _in_turns(
                lambda: ck.restore_windows(work, origins, extents, line),
                lambda: ck.restore_windows_reference(work, origins, extents, line), 10, 2)
            del work
            rk = results[f"restore_lines_{ratio}_{axis}"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, **k3b)
            print(f"{tag} K3 line form ({axis}, lines {tuple(line.values.shape)}) plane "
                  f"{(hp, wp)} windows {list(extents)}: K3 == plain (max abs err {err}); K3 "
                  f"{ms:.4f} ms ({raw[0]:.4f}, {raw[1]:.4f}), plain {plain_ms:.3f} ms, "
                  f"{_bound_text(rk)}, share of the bound {rk['bound_ms'] / ms:.4f}; "
                  f"{k3b['summed_px']} pixels summed over the windows, {k3b['union_px']} in "
                  f"their union, on {smi}")

        # K2 on per-canvas objects == its plain version, by slices, timed
        err, t0 = 0, time.perf_counter()
        for i in range(0, B, UHD_PLAIN_SLICE):
            part = ck.fused_v3_reference(pre_k2[i:i + UHD_PLAIN_SLICE].clone(),
                                         objs_p[i:i + UHD_PLAIN_SLICE],
                                         meta[i:i + UHD_PLAIN_SLICE], env)
            err = max(err, _canvas_err(part, plane[i:i + UHD_PLAIN_SLICE]))
            if not torch.equal(part, plane[i:i + UHD_PLAIN_SLICE]):
                raise AssertionError(f"{tag} K2 != plain version on canvases {i}+, "
                                     f"max abs err {err}")
            del part
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        work = pre_k2.clone()
        ms = min(cuda_ms(lambda: ck.fused_v3(work, objs_p, meta, env), 5) for _ in range(2))
        del work
        r2 = results[f"fused_v3_{ratio}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, h_columns_share=h_share,
            **_k2_bound_sliced(pre_k2, objs_p, meta, env, UHD_PLAIN_SLICE))
        print(f"{tag} K2 (per-canvas objects, envelope {tuple(env)}) B={B} in {chunks[r]} "
              f"chunks: K2 == plain (max abs err {err}); K2 {ms:.4f} ms, plain {plain_ms:.1f} "
              f"ms (one pass, host clock), {_bound_text(r2)}, share of the bound "
              f"{r2['bound_ms'] / ms:.4f}; live tiles {int(tiles.sum()):,}")
        del plane, pre_k2, meta, origins
        steps[r].release()
    del got, steps, objs_p, hw
    gc.collect()
    torch.cuda.empty_cache()
    return results, launches


def _pil_canvas(bundle, hw, rgba, boxes):
    """PIL's own compose of one solid canvas: LANCZOS resize +
    alpha_composite in list order, placements off the canvas dropped."""
    from PIL import Image

    H, W = hw
    canvas = Image.new("RGBA", (W, H), rgba)
    for oid, (x1, y1, x2, y2) in zip(bundle.object_ids(), boxes.tolist()):
        if x1 < 0 or y1 < 0 or x1 >= W or y1 >= H:
            continue
        obj = bundle.objects[oid].resize((max(1, x2 - x1), max(1, y2 - y1)), Image.LANCZOS)
        canvas.alpha_composite(obj, dest=(x1, y1))
    return canvas


HYBRID_RGBA = (128, 128, 128, 255)


def hybrid_inputs(device):
    """The hybrid phase's batch on ``device``: (bundle, host boxes, canvases
    u8 [B, H, W, 4] solid HYBRID_RGBA, objects [B, N, ph, pw, 4] (a
    broadcast view of the shared squarespace objects), obj_hw, boxes,
    envelope). Boxes from seed 0, plus an identity box and the edge box of
    benchmarks/validate_hw.py:100 (hanging off the bottom-right corner)."""
    import numpy as np
    import torch

    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.ops import compose_kernels as ck
    from image_transformation_tpu_torch.parallel.sweep import random_downscale_boxes

    bundle = load_bundle(ROOT / "data" / "squarespace")
    arrays = bundle.to_arrays()
    H, W = BATCH_HW
    B, N = HYBRID_B, arrays.obj_hw.shape[0]
    rng = np.random.default_rng(0)
    boxes_np = np.stack([random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(B)])
    oh0, ow0 = (int(v) for v in arrays.obj_hw[0])
    boxes_np[0, 0] = [W - ow0 // 2, H - oh0 // 2, W + ow0 // 2, H + oh0 // 2]
    boxes_np[1, 0] = [3, 5, 3 + ow0, 5 + oh0]
    canvases = torch.tensor(HYBRID_RGBA, dtype=torch.uint8, device=device)
    canvases = canvases.expand(B, H, W, 4).contiguous()
    objs = torch.from_numpy(arrays.objects).to(device)[None].expand(B, *arrays.objects.shape)
    hw = torch.from_numpy(np.broadcast_to(arrays.obj_hw, (B, N, 2)).copy()).to(device)
    boxes = torch.from_numpy(boxes_np).to(device)
    env = (ck._round_up(objs.shape[2], 8), ck._round_up(objs.shape[3], 128))
    return bundle, boxes_np, canvases, objs, hw, boxes, env


def phase_hybrid(smi: str):
    import numpy as np
    import torch

    from image_transformation_tpu_torch.ops import compose_kernels as ck
    from image_transformation_tpu_torch.ops.compose import composite_batch
    from image_transformation_tpu_torch.ops.roofline import blend_bound

    bundle, boxes_np, canvases, objs, hw, boxes, env = hybrid_inputs(torch.device("cuda", 0))
    B, H, W = canvases.shape[:3]
    N = objs.shape[1]

    t0 = time.perf_counter()
    ref = composite_batch(canvases, objs, hw, boxes, env)
    torch.cuda.synchronize()
    print(f"[hybrid] canvas {H}x{W} B={B} N={N} envelope {env[0]}x{env[1]}: the port's "
          f"composite_batch on the card took {time.perf_counter() - t0:.3f} s")

    results, total_launches, outs = {}, 0, {}
    for name, clamped, pipelined in HYBRID_FORMS:
        producer = ck._hybrid_producer_clamped if clamped else ck._hybrid_producer
        produce = lambda: producer(canvases, objs, hw, boxes, env, "lanczos")  # noqa: E731
        canvas_v, src_v, meta = produce()
        got = ck.window_blend(canvas_v.clone(), src_v, meta)
        want = ck.window_blend_reference(canvas_v.clone(), src_v, meta)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        changed = int((got != canvas_v).sum())
        if not torch.equal(got, want):
            raise AssertionError(f"[hybrid] {name}: K4 != plain version, max abs err {err}")
        if changed == 0:
            raise AssertionError(f"[hybrid] {name}: K4 changed no pixel")
        work_k, work_p = canvas_v.clone(), canvas_v.clone()
        ms, plain_ms, raw = _in_turns(lambda: ck.window_blend(work_k, src_v, meta),
                                      lambda: ck.window_blend_reference(work_p, src_v, meta),
                                      10, 2)
        producer_ms = cuda_ms(produce, 3)
        plane_hw = tuple(canvas_v.shape[1:])
        bnd = blend_bound(canvas_v.shape, src_v, meta)
        print(f"[hybrid] {name} {_scan_text(canvas_v.shape, src_v, meta, bnd)}")
        del got, want, work_k, work_p, canvas_v, src_v, meta

        # the slice's main path for this form: launch counts around it alone
        ck.reset_launch_counts()
        out = ck.composite_batch_hybrid_packed(canvases, objs, hw, boxes, clamped=clamped,
                                               pipelined=pipelined)
        torch.cuda.synchronize()
        launches = ck.LAUNCHES["window_blend"]
        if launches <= 0:
            raise AssertionError(f"[hybrid] {name}: the compose launched K4 {launches} times")
        if not torch.equal(out, ref):
            diff = int((out.to(torch.int32) - ref.to(torch.int32)).abs().max())
            raise AssertionError(f"[hybrid] {name}: != composite_batch, max abs err {diff}")
        total_launches += launches
        outs[name] = out
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, producer_ms=producer_ms,
                             launches=launches, **bnd)
        print(f"[hybrid] {name} (clamped={clamped}, pipelined={pipelined}) plane "
              f"{plane_hw[0]}x{plane_hw[1]}: K4 == plain (max abs err {err}, "
              f"{changed} pixels changed); K4 {ms:.3f} ms "
              f"({raw[0]:.3f}, {raw[1]:.3f}), plain {plain_ms:.3f} ms ({raw[2]:.3f}, "
              f"{raw[3]:.3f}), producer {producer_ms:.3f} ms, {_bound_text(bnd)}; compose == "
              f"composite_batch, K4 launches {launches} on {smi}")
        torch.cuda.empty_cache()

    smem = ck.launch_smem("window_blend", 0, 0, N)
    print(f"[hybrid] K4 launches per call: {launch_text(K4_PTXAS['packed'], smem)}")
    packed = ck.composite_batch_hybrid_packed(canvases, objs, hw, boxes, clamped=True,
                                              packed_out=True)
    if packed.dtype != torch.int32 or not torch.equal(ck.packed_to_u8(packed), outs["row6"]):
        raise AssertionError("[hybrid] the packed_out plane's bytes != the u8 output")
    pil_err = 0
    for b in range(4):
        pil = np.asarray(_pil_canvas(bundle, (H, W), HYBRID_RGBA, boxes_np[b]))
        got = outs["row6"][b].cpu().numpy()
        pil_err = max(pil_err, int(np.abs(got.astype(np.int32) - pil.astype(np.int32)).max()))
    if pil_err > 2:
        raise AssertionError(f"[hybrid] clamped output vs PIL: max abs err {pil_err} > 2")
    print(f"[hybrid] packed_out bytes == u8 output; clamped output vs PIL on 4 canvases: "
          f"max abs err {pil_err} (limit 2)")
    return results, total_launches, ref


#: the [ops] phase's K4 rows: (kernel-table row, producer, launcher, the meta
#: columns the launcher takes as 0, the public call: flags of
#: composite_batch_hybrid_packed or a function's name)
OPS_ROWS = (
    ("row7", "_hybrid_producer_clamped", "_pallas_blend_clamped_batchsrc", (),
     {"batchsrc": True}),
    ("row8", "_hybrid_producer_clamped", "_pallas_blend_resident", (), {"resident": True}),
    ("row9", "_hybrid_producer_clamped", "_pallas_blend_band", (), {"band": True}),
    ("row11", "_hybrid_producer_rowbaked", "_pallas_blend_rowbaked", (3,), {"rowbaked": True}),
    ("row4", "_hybrid_producer_aligned", "_pallas_blend_aligned", (2, 3),
     "composite_batch_aligned"),
    ("row2", "_hybrid_producer_planar", "_pallas_blend_planar", (), "composite_batch_hybrid"),
)


def stage_split(plane, src, meta, reps: int) -> dict:
    """Median CUDA-event ms of each stage variant of K4 (row 15) on the
    packed plane, source and meta, each on its own copy of the plane: the
    counterpart of benchmarks/bisect_resize.py --anatomy. A variant is its
    placement (the meta with its STAGE_ZEROED columns zeroed, made here, out
    of the timed call) under the blend switch: the timed call is the
    ``full`` or ``no_blend`` launch on that meta, which is the variant's
    launch without the wrapper's copy of the meta."""
    from image_transformation_tpu_torch.ops import compose_kernels as ck

    out = {}
    for variant in ck.STAGE_VARIANTS:
        work = plane.clone()
        kmeta = ck._zero_columns(meta, ck.STAGE_ZEROED[variant])
        switch = "full" if variant in ck.STAGE_BLENDS else "no_blend"
        out[variant] = cuda_ms(lambda: ck.window_blend_stage(work, src, kmeta, switch), reps)
    return out


def _ops_k4_rows(smi: str, ref) -> dict:
    import torch

    from image_transformation_tpu_torch.ops import compose_kernels as ck
    from image_transformation_tpu_torch.ops.roofline import blend_bound

    _, _, canvases, objs, hw, boxes, env = hybrid_inputs(torch.device("cuda", 0))
    rows = {}
    for row, producer_name, launcher_name, zeroed, call in OPS_ROWS:
        planar = row == "row2"
        producer = getattr(ck, producer_name)
        produce = lambda: producer(canvases, objs, hw, boxes, env, "lanczos")  # noqa: E731
        plane, src, meta = produce()
        kmeta = ck._zero_columns(meta, zeroed)
        kernel = ck.window_blend_planar if planar else ck.window_blend
        plain = ck.window_blend_planar_reference if planar else ck.window_blend_reference
        got = getattr(ck, launcher_name)(plane.clone(), src, meta)
        want = plain(plane.clone(), src, kmeta)
        torch.cuda.synchronize()
        err = (int((got.to(torch.int32) - want.to(torch.int32)).abs().max()) if planar
               else _max_abs_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"[ops] {row}: K4 != plain version, max abs err {err}")
        if torch.equal(got, plane):
            raise AssertionError(f"[ops] {row}: K4 changed no pixel")
        work_k, work_p = plane.clone(), plane.clone()
        ms, plain_ms, raw = _in_turns(lambda: kernel(work_k, src, kmeta),
                                      lambda: plain(work_p, src, kmeta), 10, 2)
        producer_ms = cuda_ms(produce, 3)
        plane_shape, src_hw = (plane.shape[0], *plane.shape[-2:]), tuple(src.shape[-2:])
        bnd = blend_bound(plane_shape, src, kmeta)
        print(f"[ops] {row} {_scan_text(plane_shape, src, kmeta, bnd)}")
        del got, want, work_k, work_p, plane, src, meta, kmeta

        # the row's public function: launch counts around it alone
        ck.reset_launch_counts()
        if isinstance(call, dict):
            out = ck.composite_batch_hybrid_packed(canvases, objs, hw, boxes, **call)
        else:
            out = getattr(ck, call)(canvases, objs, hw, boxes)
        torch.cuda.synchronize()
        key = "window_blend_planar" if planar else "window_blend"
        launches = ck.LAUNCHES[key]
        if launches <= 0:
            raise AssertionError(f"[ops] {row}: {call} launched {key} {launches} times")
        diff = int((out.to(torch.int32) - ref.to(torch.int32)).abs().max())
        if diff > 2:
            raise AssertionError(f"[ops] {row}: {call} vs composite_batch: max abs err {diff} > 2")
        rows[row] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, producer_ms=producer_ms,
                         launches=launches, vs_composite_batch=diff, **bnd)
        print(f"[ops] {row} ({call}) plane {plane_shape[1]}x{plane_shape[2]} source "
              f"{src_hw[0]}x{src_hw[1]}: {key} == plain "
              f"(max abs err {err}); kernel {ms:.3f} ms ({raw[0]:.3f}, {raw[1]:.3f}), plain "
              f"{plain_ms:.3f} ms ({raw[2]:.3f}, {raw[3]:.3f}), producer {producer_ms:.3f} ms, "
              f"{_bound_text(bnd)}; the public call launched {key} {launches} times, vs "
              f"composite_batch max abs err {diff} (limit 2) on {smi}")
        del out
        torch.cuda.empty_cache()
    smem = ck.launch_smem("window_blend", 0, 0, objs.shape[1])
    for layout in ("packed", "planar"):
        print(f"[ops] K4 {layout} entry launches per call: "
              f"{launch_text(K4_PTXAS[layout], smem)}")
    return rows


def _ops_row1(smi: str) -> dict:
    """Row 1: composite_batch_pallas_host_tables on K1 at the CLI geometry
    and at 1080p B=64."""
    import numpy as np
    import torch

    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.layout.canvas import compute_canvas_size
    from image_transformation_tpu_torch.ops import compose_kernels as ck
    from image_transformation_tpu_torch.ops.compose import composite_exact
    from image_transformation_tpu_torch.ops.roofline import k1_bound
    from image_transformation_tpu_torch.parallel.sweep import random_downscale_boxes

    device = torch.device("cuda", 0)
    bundle = load_bundle(ROOT / "data" / "squarespace")
    arrays = bundle.to_arrays()
    pad = arrays.objects.shape[1:3]
    w9, h9 = compute_canvas_size((970, 250), "9:16", verbose=False)
    out_rows = {}
    for name, (H, W), B, k_reps, p_reps in (("cli_9x16_b1", (h9, w9), 1, 8, 10),
                                             ("1080p_b64", BATCH_HW, HYBRID_B, 4, 2)):
        rng = np.random.default_rng(0)
        boxes = np.stack([random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(B)])
        obj_hw = np.broadcast_to(arrays.obj_hw, (B, *arrays.obj_hw.shape))
        canvases = torch.tensor(HYBRID_RGBA, dtype=torch.uint8, device=device)
        canvases = canvases.expand(B, H, W, 4).contiguous()
        objs = torch.from_numpy(arrays.objects).to(device)[None].expand(B, *arrays.objects.shape)
        kh, kv, _, _ = ck.fused_tables_prep(obj_hw, boxes, (H, W), pad, pad)
        args = ck._pallas_args(canvases, objs, obj_hw, boxes, kh, kv)
        got = ck.fused_compose(args[0].clone(), *args[1:])
        want = ck.fused_compose_reference(args[0].clone(), *args[1:])
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"[ops] row1 {name}: K1 != plain version, max abs err {err}")
        work_k, work_p = args[0].clone(), args[0].clone()
        ms, plain_ms, raw = _in_turns(lambda: ck.fused_compose(work_k, *args[1:]),
                                      lambda: ck.fused_compose_reference(work_p, *args[1:]),
                                      k_reps, p_reps)
        bnd = k1_bound(*args)
        del work_k, work_p, want

        ck.reset_launch_counts()
        out = ck.composite_batch_pallas_host_tables(canvases, objs, obj_hw, boxes)
        torch.cuda.synchronize()
        launches = ck.LAUNCHES["fused_compose"]
        if launches <= 0:
            raise AssertionError(f"[ops] row1 {name}: K1 launched {launches} times")
        if not torch.equal(out, got):
            raise AssertionError(f"[ops] row1 {name}: the public call != K1 on its arguments")
        for b in range(B):
            exact = composite_exact(canvases[b], objs[b], obj_hw[b], boxes[b], pad)
            pil = np.asarray(_pil_canvas(bundle, (H, W), HYBRID_RGBA, boxes[b]))
            if not torch.equal(out[b], exact):
                raise AssertionError(f"[ops] row1 {name}: canvas {b} != composite_exact")
            if not np.array_equal(out[b].cpu().numpy(), pil):
                raise AssertionError(f"[ops] row1 {name}: canvas {b} != PIL")
        out_rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, launches=launches,
                              **bnd)
        print(f"[ops] row1 composite_batch_pallas_host_tables {name} ({H}x{W} B={B}): K1 == "
              f"plain (max abs err {err}); K1 {ms:.3f} ms ({raw[0]:.3f}, {raw[1]:.3f}), plain "
              f"{plain_ms:.3f} ms ({raw[2]:.3f}, {raw[3]:.3f}), {_bound_text(bnd)}; K1 "
              f"launches {launches}; == composite_exact == PIL on all {B} canvases on {smi}")
        del args, got, out
        torch.cuda.empty_cache()
    return out_rows


def _ops_row15(smi: str) -> dict:
    """Row 15: the stage variants of K4 on row 6's inputs."""
    import torch

    from image_transformation_tpu_torch.ops import compose_kernels as ck
    from image_transformation_tpu_torch.ops.roofline import blend_bound

    _, _, canvases, objs, hw, boxes, env = hybrid_inputs(torch.device("cuda", 0))
    plane, src, meta = ck._hybrid_producer_clamped(canvases, objs, hw, boxes, env, "lanczos")
    ck.reset_launch_counts()
    split = stage_split(plane, src, meta, 10)
    torch.cuda.synchronize()
    launches = ck.LAUNCHES["window_blend_stage"]
    if launches <= 0:
        raise AssertionError(f"[ops] row15: the stage split launched {launches} times")
    variants = {}
    for variant in ck.STAGE_VARIANTS:
        got = ck.window_blend_stage(plane.clone(), src, meta, variant)
        want = ck.window_blend_stage_reference(plane.clone(), src, meta, variant)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if not torch.equal(got, want):
            raise AssertionError(f"[ops] row15 {variant}: != plain version, max abs err {err}")
        work = plane.clone()
        plain_ms = cuda_ms(lambda: ck.window_blend_stage_reference(work, src, meta, variant), 2)
        bnd = blend_bound(plane.shape, src, ck._zero_columns(meta, ck.STAGE_ZEROED[variant]),
                          blends=variant in ck.STAGE_BLENDS)
        variants[variant] = dict(max_abs_err=err, ms=split[variant], plain_ms=plain_ms, **bnd)
        print(f"[ops] row15 {variant}: == plain (max abs err {err}); kernel "
              f"{split[variant]:.3f} ms ({100 * split[variant] / split['full']:.1f}% of full), "
              f"plain {plain_ms:.3f} ms, {_bound_text(bnd)} on {smi}")
    print(f"[ops] row15 stage split launched window_blend_stage {launches} times")
    return dict(launches=launches, variants=variants)


def phase_ops(smi: str, ref):
    """The rest of the ops compose API: rows 7, 8, 9, 11, 4, 2 on K4, row 1
    on K1 and row 15's stage variants."""
    return _ops_k4_rows(smi, ref), _ops_row1(smi), _ops_row15(smi)


#: the fleet's default ratios (pipeline/fleet.py) and four more users ask for
VARIANT_RATIOS = ("9:16", "1:1", "16:9", "4:1", "4:5", "3:2", "2:3", "21:9")
FLEET_BUDGET = (1920, 1080)
FLEET_REPS = 20
WIDE_V = 64
PROFILE_REPS = 10
CLI_VARIANTS = "1:1,16:9,4:1"


def _column_root(bundle):
    return {"type": "flex", "direction": "column", "children": [
        {"object_id": oid, "name": bundle.meta[oid].label} for oid in bundle.object_ids()]}


def _variant_step(bundle, ratios, background, device, budget=FLEET_BUDGET):
    """The fleet's fused step for ``bundle`` over ``ratios`` at ``budget``
    (pipeline/fused.make_fused_render, kernel "pallas") and its arguments on
    ``device``."""
    import numpy as np
    import torch

    from image_transformation_tpu_torch.layout.canvas import compute_canvas_size
    from image_transformation_tpu_torch.layout.solve import FlexProgram
    from image_transformation_tpu_torch.pipeline import fused

    sizes = [compute_canvas_size(budget, r, verbose=False) for r in ratios]
    arrays = bundle.to_arrays()
    prog = FlexProgram.from_dsl(_column_root(bundle))
    objs, obj_wh, known = fused.map_bundle_to_program(prog, bundle, arrays)
    bg, horizontal = fused.background_spec(
        torch.from_numpy(np.array(bundle.background)).to(device), background)
    step = fused.make_fused_render(
        prog, (max(h for _, h in sizes), max(w for w, _ in sizes)), arrays.objects.shape[1:3],
        kernel="pallas", background=background, gradient_horizontal=horizontal)
    args = (torch.tensor(sizes, dtype=torch.int32, device=device), bg,
            torch.from_numpy(objs).to(device), torch.from_numpy(obj_wh).to(device),
            torch.from_numpy(known).to(device))
    return prog, step, args


def _assert_step_equal(name, card, plain):
    """Canvases, boxes and scales byte-equal; the luma within rtol 1e-5."""
    import torch

    for label, a, b in zip(("canvases", "boxes", "scales"), card[:3], plain[:3]):
        a = a.cpu()
        if not torch.equal(a, b):
            err = (a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
            raise AssertionError(f"[variants] {name}: {label} on the card != the CPU plain "
                                 f"versions, max abs err {err}")
    rel = ((card[3].cpu() - plain[3]).abs() / plain[3].abs().clamp(min=1e-30)).max().item()
    if not rel <= 1e-5:
        raise AssertionError(f"[variants] {name}: luma rel err {rel} > 1e-5")
    return rel


class _CaptureK2:
    """Keeps a copy of K2's inputs at each call the fused step makes (the
    plane as it was before the call), to hold K2 against its plain version
    at the main path's shapes afterwards."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from image_transformation_tpu_torch.pipeline import fused

        self._real = fused.fused_v3

        def recording(plane, objs_p, meta, out_max_hw):
            self.calls.append((plane.clone(), objs_p, meta.clone(), out_max_hw))
            return self._real(plane, objs_p, meta, out_max_hw)

        fused.fused_v3 = recording
        return self

    def __exit__(self, *exc):
        from image_transformation_tpu_torch.pipeline import fused

        fused.fused_v3 = self._real


def _pil_variant(bundle, root, ratio):
    """The reference's render of one ratio: the median colour of the
    background's non-transparent pixels, the host oracle's boxes, PIL's
    LANCZOS resize + alpha_composite."""
    import numpy as np
    from PIL import Image

    from image_transformation_tpu_torch.layout.canvas import compute_canvas_size
    from image_transformation_tpu_torch.layout.flex import solve_flex

    W, H = compute_canvas_size(bundle.background.size, ratio, verbose=False)
    bg = np.asarray(bundle.background.convert("RGBA"))
    px = bg[bg[..., 3] > 0][:, :3]
    color = tuple(int(np.median(px[:, c])) for c in range(3))
    out = Image.new("RGBA", (W, H), color + (255,))
    placements = solve_flex(root, (W, H), bundle.sizes())
    for p in placements:
        x1, y1, x2, y2 = p["box"]
        obj = bundle.objects[int(p["object_id"])].resize(
            (max(1, x2 - x1), max(1, y2 - y1)), Image.LANCZOS)
        out.alpha_composite(obj, dest=(x1, y1))
    return np.asarray(out), [p["box"] for p in placements]


def variants_fleet(smi: str, device, tmp: Path, budget=FLEET_BUDGET, reps=FLEET_REPS):
    """The fleet over both bundles x 8 ratios, its launch count read around
    it, its files against the same fleet on the CPU."""
    import numpy as np
    import torch
    from PIL import Image

    from image_transformation_tpu_torch.ops import compose_kernels as ck
    from image_transformation_tpu_torch.pipeline.fleet import run_fleet

    bundles = [ROOT / "data" / "squarespace", ROOT / "data" / "audio_book"]
    ck.reset_launch_counts()
    card = run_fleet(bundles, VARIANT_RATIOS, output_root=tmp / "card",
                     pixel_budget_size=budget, reps=reps, kernel="pallas", device=device)
    torch.cuda.synchronize()
    launches = ck.LAUNCHES["fused_v3"]
    passes = len(bundles) * (reps + 1)
    if launches < passes:
        raise AssertionError(
            f"[variants] the fleet launched K2 {launches} times in {passes} passes")
    run_fleet(bundles, VARIANT_RATIOS, output_root=tmp / "cpu", pixel_budget_size=budget,
              reps=1, kernel="pallas", device="cpu")
    for b in bundles:
        a, c = tmp / "card" / b.name, tmp / "cpu" / b.name
        if (json.loads((a / "boxes.json").read_text())
                != json.loads((c / "boxes.json").read_text())):
            raise AssertionError(f"[variants] fleet {b.name}: boxes on the card != on the CPU")
        for r in VARIANT_RATIOS:
            name = f"variant_{r.replace(':', 'x')}.png"
            if not np.array_equal(np.asarray(Image.open(a / name)),
                                  np.asarray(Image.open(c / name))):
                raise AssertionError(
                    f"[variants] fleet {b.name} {r}: render on the card != on the CPU")
    for stem, s in card["bundles"].items():
        sizes = " ".join(f"{r} {w}x{h}" for r, (w, h) in s["canvas_sizes"].items())
        print(f"[variants] fleet {stem} ({s['objects']} objects, {s['layout_source']}): "
              f"{1e3 * s['seconds_per_pass']:.3f} ms per pass of {len(VARIANT_RATIOS)} "
              f"canvases ({sizes})")
    print(f"[variants] fleet {len(bundles)} bundles x {len(VARIANT_RATIOS)} ratios at pixel budget "
          f"{budget[0]}x{budget[1]}, kernel pallas, reps {reps}: "
          f"{card['canvases_per_sec_device']:.1f} canvases/s per GPU "
          f"({card['total_canvases']} canvases in {card['device_seconds']:.3f} s, synchronized "
          f"per bundle); K2 launched {launches} times in {passes} passes; PNGs and boxes == the "
          f"CPU fleet's; on {card['device_name']}, {smi}")
    return card, launches


def variants_wide(smi: str, device, budget=FLEET_BUDGET, v=WIDE_V):
    """The fused step at V = ``v`` (the 8 ratios repeated), solid and
    gradient: the card's outputs == the CPU run's; K2 held against its plain
    version on the inputs the step gave it, and timed."""
    import torch

    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.ops import compose_kernels as ck
    from image_transformation_tpu_torch.ops.roofline import k2_bound

    bundle = load_bundle(ROOT / "data" / "squarespace")
    ratios = [VARIANT_RATIOS[i % len(VARIANT_RATIOS)] for i in range(v)]
    launches, k2 = 0, None
    for background in ("solid", "gradient"):
        _, step, args = _variant_step(bundle, ratios, background, device, budget)
        ck.reset_launch_counts()
        card = step(*args)
        torch.cuda.synchronize()
        n = ck.LAUNCHES["fused_v3"]
        if n < 1:
            raise AssertionError(f"[variants] V={v} {background}: K2 launched {n} times")
        launches += n
        with _CaptureK2() as cap:
            step(*args)
        plane, objs_p, meta, env = cap.calls[0]
        plane_shape = tuple(plane.shape)
        _, step_cpu, args_cpu = _variant_step(bundle, ratios, background, "cpu", budget)
        rel = _assert_step_equal(f"V={v} {background}", card, step_cpu(*args_cpu))
        step_ms = cuda_ms(lambda: step(*args), 3)
        print(f"[variants] V={v} {background} (squarespace, h_max x w_max "
              f"{card[0].shape[1]}x{card[0].shape[2]}, plane {plane_shape[1]}x{plane_shape[2]}, "
              f"{4 * plane.numel() / 1e9:.2f} GB): canvases and boxes == the CPU run's, luma rel "
              f"err {rel:.2e}; step {step_ms:.3f} ms ({v * 1e3 / step_ms:.1f} canvases/s) on {smi}")
        if background == "solid":
            out_k = ck.fused_v3(plane.clone(), objs_p, meta, env)
            out_p = ck.fused_v3_reference(plane.clone(), objs_p, meta, env)
            torch.cuda.synchronize()
            err = _max_abs_err(out_k, out_p)
            if not torch.equal(out_k, out_p):
                raise AssertionError(f"[variants] V={v}: K2 != plain version, max abs err {err}")
            del out_k, out_p
            work_k, work_p = plane.clone(), plane.clone()
            ms, plain_ms, raw = _in_turns(lambda: ck.fused_v3(work_k, objs_p, meta, env),
                                          lambda: ck.fused_v3_reference(work_p, objs_p, meta, env),
                                          5, 1)
            k2 = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      **k2_bound(plane, objs_p, meta, env))
            print(f"[variants] K2 at V={v} (the step's inputs): K2 == plain (max abs err {err}); "
                  f"K2 {ms:.3f} ms ({raw[0]:.3f}, {raw[1]:.3f}), plain {plain_ms:.3f} ms "
                  f"({raw[2]:.3f}, {raw[3]:.3f}), {_bound_text(k2)} on {smi}")
            del work_k, work_p
        del card, plane, cap
        torch.cuda.empty_cache()
    return k2, launches


def _device_events(prof, reps: int):
    """(us per name, launches per name) of the profiler's device events,
    per rep (a CPU op's own device time repeats its kernels', so only
    device events count)."""
    import torch

    us, count = {}, {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = next(float(getattr(evt, a)) for a in ("self_device_time_total",
                                                   "self_cuda_time_total") if hasattr(evt, a))
        us[evt.key] = us.get(evt.key, 0.0) + t / reps
        count[evt.key] = count.get(evt.key, 0) + evt.count / reps
    return us, count


def _profiled(fn, reps: int):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    us, count = _device_events(prof, reps)
    return us, count, wall_ms


def variants_profile(smi: str, device):
    """Where a pass's device time goes (torch.profiler): K2 against the
    solve, the statistic and the rest (plane, meta, crop), and the solve's
    launches per pass, at the fleet's V = 8 and at V = 64."""
    import torch

    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.layout.solve import solve_program
    from image_transformation_tpu_torch.ops.compose_kernels import packed_luma_masked

    bundle = load_bundle(ROOT / "data" / "squarespace")
    for v in (len(VARIANT_RATIOS), WIDE_V):
        ratios = [VARIANT_RATIOS[i % len(VARIANT_RATIOS)] for i in range(v)]
        prog, step, args = _variant_step(bundle, ratios, "solid", device)
        canvas_wh, _, _, obj_wh, known = args
        us, _, wall_ms = _profiled(lambda: step(*args), PROFILE_REPS)
        total = sum(us.values())
        if total <= 0:
            raise AssertionError(f"[variants] V={v}: the profiler saw no device time")
        k2 = sum(t for name, t in us.items() if any(key in name for _, key in K2_LAUNCHES))
        solve_us, solve_n, solve_wall = _profiled(
            lambda: solve_program(prog, canvas_wh, obj_wh, known), PROFILE_REPS)
        out = step(*args)[0]
        crop = out.view(torch.int32).squeeze(-1)
        luma_us, _, _ = _profiled(lambda: packed_luma_masked(crop, canvas_wh), PROFILE_REPS)
        solve_t, luma_t = sum(solve_us.values()), sum(luma_us.values())
        kernels = sum(n for name, n in solve_n.items() if not name.startswith("Memcpy")
                      and not name.startswith("Memset"))
        copies = sum(solve_n.values()) - kernels
        rest = total - k2 - solve_t - luma_t
        print(f"[variants] profile V={v} solid (torch.profiler, mean of {PROFILE_REPS}): step "
              f"{wall_ms:.3f} ms host wall, device busy {total / 1e3:.3f} ms (idle share "
              f"{1 - total / 1e3 / wall_ms:.3f}): K2 {k2 / 1e3:.3f} ms ({100 * k2 / total:.1f}%), "
              f"solve {solve_t / 1e3:.3f} ms ({100 * solve_t / total:.1f}%), luma "
              f"{luma_t / 1e3:.3f} ms ({100 * luma_t / total:.1f}%), plane + meta + crop "
              f"{rest / 1e3:.3f} ms ({100 * rest / total:.1f}%) on {smi}")
        print(f"[variants] device solve V={v}: {kernels:.0f} kernel launches and {copies:.0f} "
              f"copies per pass, {solve_t:.1f} us of device time, {solve_wall:.3f} ms host wall "
              f"per call on {smi}")
        del out, crop
        torch.cuda.empty_cache()


def variants_pil(smi: str, device):
    """fused_multi_ratio_render on each bundle's own pixel budget: boxes ==
    the host oracle's, solid renders within 2/255 of PIL."""
    import numpy as np
    import torch

    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.ops import compose_kernels as ck
    from image_transformation_tpu_torch.pipeline import fused_multi_ratio_render

    launches = 0
    for name in ("squarespace", "audio_book"):
        bundle = load_bundle(ROOT / "data" / name)
        root = _column_root(bundle)
        ck.reset_launch_counts()
        renders, solved = fused_multi_ratio_render(bundle, root, list(VARIANT_RATIOS),
                                                   device=device)
        torch.cuda.synchronize()
        launches += ck.LAUNCHES["fused_v3"]
        worst = 0
        for r in VARIANT_RATIOS:
            ref, boxes = _pil_variant(bundle, root, r)
            if solved[r].tolist() != boxes:
                raise AssertionError(f"[variants] {name} {r}: boxes != the host oracle's")
            if renders[r].shape != ref.shape:
                raise AssertionError(f"[variants] {name} {r}: shape {renders[r].shape}")
            worst = max(worst, int(np.abs(renders[r].astype(int) - ref.astype(int)).max()))
        if worst > 2:
            raise AssertionError(f"[variants] {name}: max err vs PIL {worst} > 2")
        print(f"[variants] fused_multi_ratio_render {name} x {len(VARIANT_RATIOS)} ratios "
              f"(its own pixel budget): boxes == layout.flex.solve_flex, max err vs PIL {worst} "
              f"(limit 2) on {smi}")
    return launches


def variants_cli(smi: str, device, tmp: Path):
    """The CLI with --variants, on the card and on the CPU: equal PNGs."""
    import numpy as np
    import torch
    from PIL import Image

    from image_transformation_tpu_torch.ops import compose_kernels as ck
    from image_transformation_tpu_torch.pipeline.cli import main

    args = ["--bundle", str(ROOT / "data" / "squarespace"), "--ratio", "9:16", "--api", "fake",
            "--refine-iters", "1", "--variants", CLI_VARIANTS]
    ck.reset_launch_counts()
    card = main(args + ["--device", str(device), "--output-root", str(tmp / "cli_card")])
    torch.cuda.synchronize()
    launches = ck.LAUNCHES["fused_v3"]
    if launches < 1:
        raise AssertionError(f"[variants] the CLI's --variants launched K2 {launches} times")
    plain = main(args + ["--device", "cpu", "--output-root", str(tmp / "cli_cpu")])
    names = sorted(p.name for p in (card / "variants").glob("*.png"))
    if names != sorted(p.name for p in (plain / "variants").glob("*.png")) or len(names) != 4:
        raise AssertionError(f"[variants] the CLI wrote {names}")
    for n in names:
        if not np.array_equal(np.asarray(Image.open(card / "variants" / n)),
                              np.asarray(Image.open(plain / "variants" / n))):
            raise AssertionError(f"[variants] CLI {n}: the card's != the CPU's")
    print(f"[variants] CLI --api fake --refine-iters 1 --variants {CLI_VARIANTS}: {names} == the "
          f"CPU CLI's; K2 launched {launches} times on {smi}")
    return launches


def phase_variants(smi: str):
    """The multi-ratio fused render at a fleet user's size: the fleet, the
    wide batch, the oracle check, the CLI, and the profile."""
    import torch

    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_variants_") as tmp:
        fleet, fleet_launches = variants_fleet(smi, device, Path(tmp))
        k2, wide_launches = variants_wide(smi, device)
        pil_launches = variants_pil(smi, device)
        cli_launches = variants_cli(smi, device, Path(tmp))
    variants_profile(smi, device)
    return k2, fleet_launches + wide_launches + pil_launches + cli_launches


#: /v1/render's ratios and backgrounds in the [serving] phase
SERVING_RATIOS = ("9:16", "1:1", "16:9", "4:1")
SERVING_SEQUENTIAL = 200
SERVING_CLIENTS = 16
SERVING_MERGE_REQUESTS = 128
SERVING_BATCH_REPS = 20


def _post(base: str, path: str, payload: dict):
    """(body bytes, headers) of one POST; raises on a non-200 reply."""
    import urllib.request

    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 method="POST", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        if r.status != 200:
            raise AssertionError(f"[serving] {path} {payload}: HTTP {r.status}")
        return r.read(), dict(r.headers)


def _decode_png(body: bytes):
    import io

    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)).convert("RGBA"))


def _service_pil(service, stem, canvas_size, background, placements):
    """PIL's own compose on the service's canvas: LANCZOS resize +
    alpha_composite in list order."""
    import numpy as np
    from PIL import Image

    bundle = service._bundle(stem)
    canvas = Image.fromarray(service._canvas(bundle, canvas_size, background).cpu().numpy(),
                             "RGBA")
    for p in placements:
        x1, y1, x2, y2 = (int(v) for v in p["box"])
        canvas.alpha_composite(bundle.objects[int(p["object_id"])].resize(
            (max(1, x2 - x1), max(1, y2 - y1)), Image.LANCZOS), dest=(x1, y1))
    return np.asarray(canvas)


def _merge_layouts(bundle_ids, n):
    """``n`` distinct layouts on one bundle: column and row, eight gaps,
    eight object subsets."""
    subsets = [list(bundle_ids), list(bundle_ids[:2]), list(bundle_ids[1:]),
               list(bundle_ids[::-1]), [bundle_ids[0]], [bundle_ids[-1]],
               list(bundle_ids[::2]), list(bundle_ids[1::2])]
    out = []
    for direction in ("column", "row"):
        for gap in (0, 3, 6, 10, 15, 21, 28, 36):
            for ids in subsets:
                out.append({"root": {"type": "flex", "direction": direction, "gap_px": gap,
                                     "children": [{"object_id": i} for i in ids]}})
    return out[:n]


def _pct(samples, q):
    s = sorted(samples)
    return s[min(len(s) - 1, int(len(s) * q))]


def serving_render(base, card, cpu, smi):
    """/v1/render on both bundles x 4 ratios x {solid, gradient}, PNG and
    raw, against the CPU service and PIL; K1's count read around it."""
    import numpy as np
    import torch

    from image_transformation_tpu_torch.ops import compose_kernels as ck

    ck.reset_launch_counts()
    replies = []
    for stem in ("squarespace", "audio_book"):
        for ratio in SERVING_RATIOS:
            for background in ("solid", "gradient"):
                req = {"bundle": stem, "ratio": ratio, "background": background}
                png, _ = _post(base, "/v1/render", req)
                raw, headers = _post(base, "/v1/render", {**req, "format": "raw"})
                shape = tuple(int(v) for v in headers["X-Raw-Shape"].split(","))
                replies.append((req, _decode_png(png),
                                np.frombuffer(raw, np.uint8).reshape(shape)))
    torch.cuda.synchronize()
    launches = ck.LAUNCHES["fused_compose"]
    if launches <= 0:
        raise AssertionError(f"[serving] /v1/render launched K1 {launches} times")
    for req, png, raw in replies:
        placements, canvas_size, want = cpu.render(req["bundle"], req["ratio"],
                                                   background=req["background"])
        pil = _service_pil(cpu, req["bundle"], canvas_size, req["background"], placements)
        for name, got in (("png", png), ("raw", raw)):
            if not np.array_equal(got, want):
                raise AssertionError(f"[serving] /v1/render {req} {name}: != the CPU service")
            if not np.array_equal(got, pil):
                raise AssertionError(f"[serving] /v1/render {req} {name}: != PIL")
    print(f"[serving] /v1/render: 2 bundles x {len(SERVING_RATIOS)} ratios x 2 backgrounds, "
          f"PNG and raw ({len(replies) * 2} requests): == the CPU service == PIL (max abs err 0); "
          f"K1 launched {launches} times on {smi}")
    return launches


def serving_merges(base, card, cpu, smi):
    """128 distinct layouts on one key from 16 client threads: merged
    dispatches, every reply == its sequential CPU render."""
    import concurrent.futures

    import numpy as np
    import torch

    from image_transformation_tpu_torch.ops import compose_kernels as ck

    layouts = _merge_layouts(card._bundle("squarespace").object_ids(), SERVING_MERGE_REQUESTS)
    before = card.coalescing_stats()
    ck.reset_launch_counts()

    def one(layout):
        body, _ = _post(base, "/v1/render", {"bundle": "squarespace", "ratio": "9:16",
                                             "layout": layout})
        return _decode_png(body)

    with concurrent.futures.ThreadPoolExecutor(max_workers=SERVING_CLIENTS) as pool:
        outs = list(pool.map(one, layouts))
    torch.cuda.synchronize()
    launches = ck.LAUNCHES["fused_compose"]
    after = card.coalescing_stats()
    requests = after["requests"] - before["requests"]
    dispatches = after["dispatches"] - before["dispatches"]
    if requests != len(layouts) or not dispatches < requests:
        raise AssertionError(f"[serving] merges: {dispatches} dispatches for {requests} requests")
    for layout, out in zip(layouts, outs):
        if not np.array_equal(out, cpu.render("squarespace", "9:16", layout)[2]):
            raise AssertionError(f"[serving] merged render {layout}: != its CPU render")
    print(f"[serving] {requests} distinct layouts from {SERVING_CLIENTS} clients on one key "
          f"(squarespace 9:16 solid): {dispatches} dispatches (merged, K1 with B > 1), K1 "
          f"launched {launches} times; every reply == its sequential CPU render on {smi}")
    return launches


def _batch_payload_arrays(payload):
    import base64

    return {r: (e["canvas"], e["boxes"], _decode_png(base64.b64decode(e["png_b64"])))
            for r, e in payload.items()}


def serving_batch(base, card, cpu, smi):
    """/v1/render_batch (buffered and NDJSON) and /v1/render_fleet at 8
    ratios on both bundles against the CPU service and PIL; K2's count read
    around them."""
    import numpy as np
    import torch

    from image_transformation_tpu_torch.ops import compose_kernels as ck

    ratios = list(VARIANT_RATIOS)
    ck.reset_launch_counts()
    got = {}
    for stem in ("squarespace", "audio_book"):
        body, _ = _post(base, "/v1/render_batch", {"bundle": stem, "ratios": ratios})
        got[("batch", stem)] = _batch_payload_arrays(json.loads(body))
        body, headers = _post(base, "/v1/render_batch", {"bundle": stem, "ratios": ratios,
                                                         "stream": True})
        if "ndjson" not in headers.get("Content-Type", ""):
            raise AssertionError("[serving] render_batch stream: not NDJSON")
        lines = [json.loads(ln) for ln in body.decode().splitlines() if ln]
        got[("stream", stem)] = _batch_payload_arrays({ln.pop("ratio"): ln for ln in lines})
    body, _ = _post(base, "/v1/render_fleet", {"bundles": ["squarespace", "audio_book"],
                                               "ratios": ratios})
    for stem, entry in json.loads(body).items():
        got[("fleet", stem)] = _batch_payload_arrays(entry)
    torch.cuda.synchronize()
    launches = ck.LAUNCHES["fused_v3"]
    if launches <= 0:
        raise AssertionError(f"[serving] render_batch/fleet launched K2 {launches} times")
    pil_err = 0
    for (mode, stem), per_ratio in got.items():
        want = cpu.render_batch(stem, ratios)
        if list(per_ratio) != ratios:
            raise AssertionError(f"[serving] {mode} {stem}: ratios {list(per_ratio)}")
        for r, (canvas, boxes, img) in per_ratio.items():
            (w, h), want_boxes, want_img = want[r]
            if canvas != {"width": w, "height": h} or boxes != want_boxes:
                raise AssertionError(f"[serving] {mode} {stem} {r}: boxes != the CPU service's")
            if not np.array_equal(img, want_img):
                raise AssertionError(f"[serving] {mode} {stem} {r}: canvas != the CPU service's")
            placements = [{"object_id": oid, "box": b}
                          for oid, b in zip(cpu._bundle(stem).object_ids(), boxes)]
            pil = _service_pil(cpu, stem, (w, h), "solid", placements)
            pil_err = max(pil_err, int(np.abs(img.astype(int) - pil.astype(int)).max()))
    if pil_err > 2:
        raise AssertionError(f"[serving] render_batch/fleet vs PIL: max abs err {pil_err} > 2")
    print(f"[serving] /v1/render_batch (buffered and NDJSON) and /v1/render_fleet, 2 bundles x "
          f"{len(ratios)} ratios: canvases and boxes == the CPU service's; max abs err vs PIL "
          f"{pil_err} (limit 2); K2 launched {launches} times on {smi}")
    return launches


def serving_timings(base, card, smi):
    """Latency and throughput of the daemon on the card (host clocks around
    whole HTTP requests, each ending in its reply)."""
    import concurrent.futures
    import statistics

    from image_transformation_tpu_torch.layout.canvas import compute_canvas_size

    req = {"bundle": "squarespace", "ratio": "9:16"}
    _post(base, "/v1/render", req)  # warm
    lat, splits = [], []
    for _ in range(SERVING_SEQUENTIAL):
        t0 = time.perf_counter()
        _, headers = _post(base, "/v1/render", req)
        lat.append((time.perf_counter() - t0) * 1e3)
        splits.append(json.loads(headers["X-Render-Timings"]))
    split = {k: statistics.median(float(t[k]) for t in splits)
             for k in splits[0] if isinstance(splits[0][k], (int, float))}
    print(f"[serving] /v1/render squarespace 9:16 PNG, {SERVING_SEQUENTIAL} sequential requests: "
          f"p50 {_pct(lat, 0.5):.3f} ms, p95 {_pct(lat, 0.95):.3f} ms (HTTP end to end) on {smi}")
    print("[serving] median X-Render-Timings split (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + f" on {smi}")

    layouts = _merge_layouts(card._bundle("squarespace").object_ids(), 64)
    per_client = 20

    def client(c):
        out = []
        for i in range(per_client):
            t0 = time.perf_counter()
            _post(base, "/v1/render", {**req, "layout": layouts[(c * per_client + i) % 64]})
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=SERVING_CLIENTS) as pool:
        conc = [x for xs in pool.map(client, range(SERVING_CLIENTS)) for x in xs]
    wall = time.perf_counter() - t0
    print(f"[serving] /v1/render, {SERVING_CLIENTS} concurrent clients x {per_client} requests "
          f"(64 layouts on one key): {len(conc) / wall:.1f} requests/s, p50 "
          f"{_pct(conc, 0.5):.3f} ms, p95 {_pct(conc, 0.95):.3f} ms on {smi}")

    batch = {"bundle": "squarespace", "ratios": list(VARIANT_RATIOS)}
    _post(base, "/v1/render_batch", batch)
    blat = []
    for _ in range(SERVING_BATCH_REPS):
        t0 = time.perf_counter()
        _post(base, "/v1/render_batch", batch)
        blat.append((time.perf_counter() - t0) * 1e3)
    print(f"[serving] /v1/render_batch squarespace at {len(VARIANT_RATIOS)} ratios (PNG + base64 "
          f"JSON), {SERVING_BATCH_REPS} requests: p50 {_pct(blat, 0.5):.3f} ms on {smi}")

    canvas_size = compute_canvas_size((970, 250), "9:16", verbose=False)
    engine = card._engine("squarespace", canvas_size, "solid")
    sets = [card.solve("squarespace", "9:16", layouts[i])[0] for i in range(8)]
    single = engine.measure_device_ms(sets[:1], reps=48)
    merged = engine.measure_device_ms(sets, reps=48)
    print(f"[serving] measure_device_ms (48 reps, one fence): single request {single:.4f} ms, "
          f"merge of 8 {merged:.4f} ms ({merged / 8:.4f} ms per request) on {smi}")


def phase_serving(smi: str) -> dict:
    """The serving daemon in process on the card, driven over HTTP, against
    the CPU service (the plain versions) and PIL; then its timings."""
    import threading
    import urllib.request

    import torch

    from image_transformation_tpu_torch.serving import ComposeService, serve

    with tempfile.TemporaryDirectory(prefix="chip_smoke_serving_") as tmp:
        card = ComposeService(ROOT / "data", Path(tmp) / "card.json", device="cuda")
        cpu = ComposeService(ROOT / "data", Path(tmp) / "cpu.json", device="cpu")
        daemon = serve(ROOT / "data", port=0, service=card)
        thread = threading.Thread(target=daemon.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{daemon.server_address[1]}"
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            if not health["ok"] or torch.cuda.get_device_name(0) not in health["device"]:
                raise AssertionError(f"[serving] /healthz does not name the card: {health}")
            print(f"[serving] /healthz: {health}")
            k1 = serving_render(base, card, cpu, smi)
            k1 += serving_merges(base, card, cpu, smi)
            k2 = serving_batch(base, card, cpu, smi)
            serving_timings(base, card, smi)
        finally:
            daemon.shutdown()
            daemon.server_close()
            thread.join(timeout=60)
        stats = card.stats()
        print(f"[serving] /v1/stats dispatch_floor {stats['dispatch_floor']}, coalescing "
              f"{card.coalescing_stats()}")
        t0 = time.perf_counter()
        card.close()
        t1 = time.perf_counter()
        cpu.close()
        t2 = time.perf_counter()
        alive = [t.name for t in threading.enumerate() if t.name == "coalescer-drain"]
        if alive:
            raise AssertionError(f"[serving] drain workers alive after close(): {alive}")
        print(f"[serving] both services closed (card {t1 - t0:.3f} s, cpu {t2 - t1:.3f} s): "
              "no drain worker alive")
    return {"fused_compose": k1, "fused_v3": k2}


def phase_agentic(smi: str) -> int:
    """The agentic loop on the card (fake client, squarespace 9:16, 2
    iterations): its drafts against the CPU run and PIL; K1's count read
    around it."""
    import numpy as np
    import torch
    from PIL import Image

    from image_transformation_tpu_torch.agentic import run_workflow
    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.ops import compose_kernels as ck
    from image_transformation_tpu_torch.vlm.client import FakeClient, register_fake_client

    bundle = load_bundle(ROOT / "data" / "squarespace")
    layout = {"root": {"type": "flex", "direction": "column", "gap_px": 4, "children": [
        {"object_id": oid, "name": bundle.meta[oid].label} for oid in bundle.object_ids()]}}
    micro = {"message": {"content": "", "tool_calls": [
        {"id": f"c{i}", "function": {"name": name, "arguments": json.dumps(args)}}
        for i, (name, args) in enumerate((("adjust_x", {"object": "logo", "pixels": 10}),
                                          ("adjust_y", {"object": "4", "pixels": -5})))]}}
    script = [json.dumps(layout), "Score: 7/10\nmove the logo", micro,
              "Score: 8/10\nnudge again", micro, "Score: 9/10\nLooks good."]
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_agentic_") as tmp:
        for device in ("cuda", "cpu"):
            register_fake_client(lambda: FakeClient(script))
            try:
                if device == "cuda":
                    ck.reset_launch_counts()
                t0 = time.perf_counter()
                run_workflow(ROOT / "data" / "squarespace", "9:16", Path(tmp) / device,
                             max_iterations=2, device=device)
                if device == "cuda":
                    torch.cuda.synchronize()
                    launches = ck.LAUNCHES["fused_compose"]
                    seconds = time.perf_counter() - t0
            finally:
                register_fake_client(None)
            root = Path(tmp) / device / "squarespace"
            runs[device] = [
                (np.asarray(Image.open(it / "final_product" / f"draft_macro_iter_{it.name[-2:]}.png")),
                 json.loads((it / "layout_json" / f"layout_macro_iter_{it.name[-2:]}.json")
                            .read_text()))
                for it in sorted(root.glob("iteration_*"))]
    if launches <= 0:
        raise AssertionError(f"[agentic] K1 launched {launches} times")
    if len(runs["cuda"]) != 3 or len(runs["cpu"]) != 3:
        raise AssertionError(f"[agentic] drafts: {len(runs['cuda'])} on the card, "
                             f"{len(runs['cpu'])} on the CPU (3 expected)")
    bg = np.asarray(bundle.background.convert("RGBA"))
    color = tuple(int(np.median(bg[bg[..., 3] > 0][:, c])) for c in range(3))
    for i, ((got, lay), (want, want_lay)) in enumerate(zip(runs["cuda"], runs["cpu"])):
        pil = Image.new("RGBA", (got.shape[1], got.shape[0]), color + (255,))
        for p in lay["placements"]:
            pil.alpha_composite(bundle.objects[p["object_id"]], dest=tuple(p["box"][:2]))
        if lay != want_lay or not np.array_equal(got, want):
            raise AssertionError(f"[agentic] iteration {i}: the card's draft != the CPU run's")
        if not np.array_equal(got, np.asarray(pil)):
            raise AssertionError(f"[agentic] iteration {i}: the card's draft != PIL")
    print(f"[agentic] run_workflow squarespace 9:16, fake client, 2 iterations on the card: "
          f"{len(runs['cuda'])} drafts == the CPU run's == PIL (max abs err 0); K1 launched "
          f"{launches} times; {seconds:.3f} s for the run on {smi}")
    return launches


MESH_B = 64
MESH_MERGE_B = 8
MESH_REPS = 5
MESH_SECONDS = 300


def _host_ms(fn, reps: int) -> float:
    """Median host-clock ms of ``fn()`` followed by a synchronize, after one
    warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _counted(fn):
    """``fn()`` with the launch counts reset just before and read just after."""
    import torch

    from image_transformation_tpu_torch.ops import compose_kernels as ck

    torch.cuda.synchronize()
    ck.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ck.LAUNCHES)


def _mesh_solid(mesh, dev):
    """make_sharded_solid_render at 1080x1920, B = MESH_B (squarespace
    objects shared, boxes from seed 0) against the single-GPU render."""
    import numpy as np
    import torch

    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.ops import compose_kernels as ck
    from image_transformation_tpu_torch.parallel.mesh import shard_batched
    from image_transformation_tpu_torch.parallel.sweep import (
        make_sharded_solid_render,
        random_downscale_boxes,
    )

    arrays = load_bundle(ROOT / "data" / "squarespace").to_arrays()
    H, W = BATCH_HW
    N = arrays.obj_hw.shape[0]
    rng = np.random.default_rng(0)
    boxes = np.stack([random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(MESH_B)])
    hw = np.broadcast_to(arrays.obj_hw, (MESH_B, N, 2)).copy()
    objs_p = ck.planarize_objects(torch.from_numpy(arrays.objects).to(dev)[None])
    pad = arrays.objects.shape[1:3]
    step = make_sharded_solid_render(mesh, (H, W), pad)
    (plane, luma), counts = _counted(lambda: step(objs_p, hw, boxes))
    whole = ck.render_solid_fused_v3_program(
        objs_p, torch.from_numpy(hw).to(dev), torch.from_numpy(boxes).to(dev), (H, W),
        ck.pack_rgba_scalar((128, 128, 128, 255)), pad)
    want_luma = float(ck.packed_luma(whole[:, :H, :W]).mean())
    return {"launches": counts["fused_v3"], "equal": bool(torch.equal(
                plane, shard_batched(mesh).local(whole))),
            "luma": [float(luma[0]), want_luma], "local_b": int(plane.shape[0]),
            "step_ms": _host_ms(lambda: step(objs_p, hw, boxes), MESH_REPS),
            "all_reduce_ms": _host_ms(
                lambda: mesh.all_reduce_sum(torch.zeros(1, device=dev), "data"), MESH_REPS)}


def _mesh_fused(mesh, dev, tmp: Path):
    """The sharded fused render at the [variants] fleet size: per bundle,
    the first 7 of the 8 ratios padded to 8 and masked (ragged) against the
    single-GPU step; then run_fleet(mesh=) over both bundles x 8 ratios,
    whose tree rank 0 holds against the single-GPU fleet's."""
    import numpy as np
    import torch
    from PIL import Image

    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.parallel.mesh import shard_batched
    from image_transformation_tpu_torch.pipeline import fused
    from image_transformation_tpu_torch.pipeline.fleet import run_fleet

    res = {"launches": 0, "equal": True, "luma": [], "step_ms": [], "all_reduce_ms": None}
    batch = shard_batched(mesh)
    for name in ("squarespace", "audio_book"):
        bundle = load_bundle(ROOT / "data" / name)
        prog, single, args = _variant_step(bundle, VARIANT_RATIOS[:-1], "solid", dev)
        wh, valid = fused.pad_ragged_variants(args[0].cpu().numpy(), mesh.size())
        h_max, w_max = (int(wh[:, 1].max()), int(wh[:, 0].max()))
        arrays = bundle.to_arrays()
        step = fused.make_sharded_fused_render(mesh, prog, (h_max, w_max),
                                               arrays.objects.shape[1:3], masked=True,
                                               kernel="pallas")
        margs = (wh, *args[1:], valid)
        (out, boxes, luma), counts = _counted(lambda: step(*margs))
        res["launches"] += counts["fused_v3"]
        want = single(torch.from_numpy(wh).to(dev), *args[1:])
        res["equal"] &= bool(torch.equal(out, batch.local(want[0]))
                             and torch.equal(boxes, batch.local(want[1])))
        res["luma"].append([float(luma[0]), float(want[3][:len(VARIANT_RATIOS) - 1].mean())])
        res["step_ms"].append(_host_ms(lambda: step(*margs), MESH_REPS))
    res["all_reduce_ms"] = _host_ms(
        lambda: mesh.all_reduce_sum(torch.zeros(2, device=dev), "data"), MESH_REPS)
    bundles = [ROOT / "data" / "squarespace", ROOT / "data" / "audio_book"]
    fleet, counts = _counted(lambda: run_fleet(
        bundles, VARIANT_RATIOS, output_root=tmp / f"fleet_{mesh.size()}", mesh=mesh,
        pixel_budget_size=FLEET_BUDGET, kernel="pallas"))
    res["launches"] += counts["fused_v3"]
    res["fleet_ms_per_pass"] = [1e3 * b["seconds_per_pass"] for b in fleet["bundles"].values()]
    if mesh.rank == 0:
        one = tmp / f"fleet_single_{mesh.size()}"
        run_fleet(bundles, VARIANT_RATIOS, output_root=one, pixel_budget_size=FLEET_BUDGET,
                  kernel="pallas", device=dev)
        for b in bundles:
            a, c = tmp / f"fleet_{mesh.size()}" / b.name, one / b.name
            res["equal"] &= (json.loads((a / "boxes.json").read_text())
                             == json.loads((c / "boxes.json").read_text()))
            for r in VARIANT_RATIOS:
                name = f"variant_{r.replace(':', 'x')}.png"
                res["equal"] &= bool(np.array_equal(np.asarray(Image.open(a / name)),
                                                    np.asarray(Image.open(c / name))))
    return res


def _mesh_merge(mesh, dev):
    """The sharded merge: MESH_MERGE_B placement sets on serving's 9:16
    canvas, split over the ranks, against the engine's compose of each."""
    import numpy as np
    import torch

    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.layout.canvas import compute_canvas_size
    from image_transformation_tpu_torch.ops.background import synthesize_canvas
    from image_transformation_tpu_torch.parallel.mesh import shard_batched
    from image_transformation_tpu_torch.parallel.sweep import (
        random_downscale_boxes,
        sharded_compose_many,
    )
    from image_transformation_tpu_torch.pipeline.engine import ComposeEngine

    bundle = load_bundle(ROOT / "data" / "squarespace")
    arrays = bundle.to_arrays()
    W, H = compute_canvas_size(bundle.background.size, "9:16", verbose=False)
    canvas = synthesize_canvas(torch.from_numpy(np.asarray(bundle.background).copy()).to(dev),
                               W, H, "solid")
    engine = ComposeEngine(arrays, canvas, dev)
    rng = np.random.default_rng(0)
    ids = [int(i) for i in arrays.object_ids[:arrays.n_valid]]
    sets = []
    for i in range(MESH_MERGE_B):
        boxes = random_downscale_boxes(rng, arrays.obj_hw, (H, W))
        n = 1 + i % len(ids)
        sets.append([{"object_id": oid, "box": boxes[k].tolist()}
                     for k, oid in enumerate(ids[:n])])
    lives = [engine.validate_placements(ps) for ps in sets]
    per = [engine.indexed_args_np(live, len(ids)) for live in lives]
    stacked = [torch.from_numpy(np.stack([a[i] for a in per])).to(dev) for i in range(5)]
    objs = torch.from_numpy(arrays.objects).to(dev)
    out, counts = _counted(lambda: sharded_compose_many(mesh, canvas, objs, *stacked))
    mine = shard_batched(mesh).local(np.arange(MESH_MERGE_B))
    equal = all(torch.equal(out[j], engine.compose(lives[i])) for j, i in enumerate(mine))
    return {"launches": counts["fused_compose"], "equal": equal, "canvas": [H, W],
            "local_b": int(out.shape[0]),
            "step_ms": _host_ms(lambda: sharded_compose_many(mesh, canvas, objs, *stacked),
                                MESH_REPS)}


def mesh_rank(rank: int, tmp: str, world: int, backend: str) -> None:
    """One rank of the [mesh] phase on cuda:0: gloo over a file store for a
    world of ``world`` > 1, or make_mesh's own world of one for nccl. Writes
    its results to ``<tmp>/mesh_<backend>_<world>_<rank>.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    from image_transformation_tpu_torch.parallel.mesh import make_mesh

    tmp = Path(tmp)
    dev = torch.device("cuda", 0)
    if world > 1:
        dist.init_process_group(backend, init_method=f"file://{tmp / f'store_{backend}'}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=120))
    mesh = make_mesh(device=dev, backend=backend)
    try:
        res = {"mesh": repr(mesh), "backend": mesh.backend, "world": mesh.size(),
               "solid": _mesh_solid(mesh, dev), "fused": _mesh_fused(mesh, dev, tmp),
               "merge": _mesh_merge(mesh, dev)}
    finally:
        mesh.close()
        if dist.is_initialized():
            dist.destroy_process_group()
    (tmp / f"mesh_{backend}_{world}_{rank}.json").write_text(json.dumps(res))


def phase_mesh(smi: str) -> dict:
    """Two gloo ranks both on cuda:0 (spawned; NCCL refuses two ranks on one
    card), then a world of one over nccl in this process: each rank's K1/K2
    launches (> 0), outputs == the single-GPU run's (luma within rtol 1e-5),
    and its step and all-reduce times."""
    import torch.multiprocessing as mp

    out = {"fused_compose": 0, "fused_v3": 0}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        ctx = mp.start_processes(mesh_rank, args=(tmp, 2, "gloo"), nprocs=2, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + MESH_SECONDS
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise AssertionError(f"[mesh] the gloo ranks ran past {MESH_SECONDS} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        mesh_rank(0, tmp, 1, "nccl")
        runs = [("gloo", 2, r) for r in range(2)] + [("nccl", 1, 0)]
        for backend, world, rank in runs:
            res = json.loads((Path(tmp) / f"mesh_{backend}_{world}_{rank}.json").read_text())
            if res["backend"] != backend:
                raise AssertionError(f"[mesh] asked for {backend}, ran {res['backend']}")
            tag = f"[mesh] {backend} world {world} rank {rank} on cuda:0"
            s, f, m = res["solid"], res["fused"], res["merge"]
            for name, part, kernel in (("solid render", s, "K2"), ("fused render", f, "K2"),
                                       ("merge", m, "K1")):
                if part["launches"] <= 0 or not part["equal"]:
                    raise AssertionError(f"{tag}: {name} launched {kernel} "
                                         f"{part['launches']} times, equal {part['equal']}")
            for got, want in [s["luma"], *f["luma"]]:
                if abs(got - want) > 1e-5 * abs(want):
                    raise AssertionError(f"{tag}: luma {got} != single-GPU {want} (rtol 1e-5)")
            print(f"{tag}: make_sharded_solid_render {BATCH_HW[0]}x{BATCH_HW[1]} B={MESH_B} "
                  f"({s['local_b']} here): K2 launched {s['launches']} times, planes == the "
                  f"single-GPU render, luma {s['luma'][0]:.6f} vs {s['luma'][1]:.6f}; step "
                  f"{s['step_ms']:.3f} ms, all-reduce (1 float) {s['all_reduce_ms']:.3f} ms")
            print(f"{tag}: make_sharded_fused_render (pallas, masked) 7 ratios padded to 8 at "
                  f"{FLEET_BUDGET[0]}x{FLEET_BUDGET[1]}, both bundles: K2 launched "
                  f"{f['launches']} times with run_fleet(mesh=) over 8 ratios; canvases and "
                  f"boxes == the single-GPU step, fleet PNGs and boxes == the single-GPU "
                  f"fleet (rank 0); step {', '.join(f'{x:.3f}' for x in f['step_ms'])} ms, "
                  f"fleet pass {', '.join(f'{x:.3f}' for x in f['fleet_ms_per_pass'])} ms, "
                  f"all-reduce (2 floats) {f['all_reduce_ms']:.3f} ms")
            print(f"{tag}: sharded merge B={MESH_MERGE_B} ({m['local_b']} here) at "
                  f"{m['canvas'][0]}x{m['canvas'][1]}: K1 launched {m['launches']} times, "
                  f"== the engine's compose of each set; step {m['step_ms']:.3f} ms "
                  f"(no all-reduce)")
            out["fused_compose"] += m["launches"]
            out["fused_v3"] += s["launches"] + f["launches"]
    print(f"[mesh] every rank launched its kernels and equals the single-GPU run on {smi}")
    return out


def phase_ui(smi: str) -> int:
    """The port's headless main app on the card (squarespace 9:16, fake
    client, 2 refinements) with K1's count read around it, its drafts ==
    PIL; compat.compositor.composite on the card == PIL."""
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from image_transformation_tpu_torch.compat import compositor
    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.ui import app, headless
    from image_transformation_tpu_torch.vlm.client import register_fake_client

    bundle = load_bundle(ROOT / "data" / "squarespace")
    bg = np.asarray(bundle.background.convert("RGBA"))
    color = tuple(int(np.median(bg[bg[..., 3] > 0][:, c])) for c in range(3))
    saved = app.REPO_ROOT
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ui_") as tmp:
        root = Path(tmp)
        (root / "data").symlink_to(ROOT / "data")
        (root / "input").mkdir()
        shutil.copy(ROOT / "input" / "squarespace.jpg", root / "input" / "squarespace.jpg")
        app.REPO_ROOT = root
        try:
            st = headless.HeadlessStreamlit()
            headless.run_app("main", st, {"select_squarespace.jpg": True}, device="cuda")
            (_, counts) = _counted(lambda: headless.run_app("main", st, {
                "VLM backend": "fake (hermetic)", "Refine iterations": 2,
                "Run macro placement": True}, device="cuda"))
        finally:
            app.REPO_ROOT = saved
            register_fake_client(None)
        if not st.session_state.get("has_run"):
            raise AssertionError(f"[ui] the main app did not run:\n{st.transcript()}")
        launches = counts["fused_compose"]
        run = root / "output_macro_placement" / "squarespace"
        drafts = sorted(run.glob("iteration_*/final_product/draft_macro_iter_*.png"))
        if launches <= 0 or not drafts:
            raise AssertionError(f"[ui] K1 launched {launches} times, {len(drafts)} drafts")
        for d in drafts:
            it = d.name[-6:-4]
            lay = json.loads((d.parents[1] / "layout_json" / f"layout_macro_iter_{it}.json")
                             .read_text())
            got = np.asarray(Image.open(d))
            pil = _pil_compose(bundle, Image.new("RGBA", (got.shape[1], got.shape[0]),
                                                 color + (255,)), lay["placements"])
            if not np.array_equal(got, np.asarray(pil)):
                raise AssertionError(f"[ui] draft {d.name} != PIL")
        iterations = len(list(run.glob("iteration_*")))
    print(f"[ui] headless main app, squarespace 9:16, fake client, 2 refinements on the card: "
          f"{iterations} iterations, {len(drafts)} draft(s) == PIL (max abs err 0); K1 launched "
          f"{launches} times on {smi}")

    canvas = Image.new("RGBA", (657, 369), color + (255,))
    placements = []  # scales 0.5, 0.75, 1 and 1.25 (an upscale)
    for i, oid in enumerate(sorted(bundle.objects)):
        w, h = (v * (i + 2) // 4 + 1 for v in bundle.objects[oid].size)
        placements.append({"object_id": oid, "box": [40 * i, 15 * i, 40 * i + w, 15 * i + h]})
    got, counts = _counted(lambda: np.asarray(compositor.composite(
        canvas, bundle.objects, placements, device="cuda")))
    want = _pil_compose(bundle, canvas.copy(), placements)
    if counts["fused_compose"] != 1 or not np.array_equal(got, np.asarray(want)):
        raise AssertionError(f"[ui] compat composite: K1 launched {counts['fused_compose']} "
                             f"times, == PIL {np.array_equal(got, np.asarray(want))}")
    print(f"[ui] compat.compositor.composite on the card (squarespace, {len(placements)} "
          f"placements, downscales and an upscale, 657x369): == PIL (max abs err 0), K1 "
          f"launched once")
    return launches + counts["fused_compose"] + ui_reference_cli(smi, bundle, color)


def ui_reference_cli(smi: str, bundle, color) -> int:
    """compat.macro_placement_test.main (fake client, 1 refinement) with
    --device cuda, K1's count read around it, and --device cpu: drafts
    byte-equal to each other and == PIL."""
    import numpy as np
    from PIL import Image

    from image_transformation_tpu_torch.compat import macro_placement_test
    from image_transformation_tpu_torch.vlm.client import register_fake_client

    args = ["--bundle", str(ROOT / "data" / "squarespace"), "--ratio", "9:16", "--api", "fake",
            "--refine-iters", "1"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mpt_") as tmp:
        try:
            card, counts = _counted(lambda: macro_placement_test.main(
                args + ["--device", "cuda", "--output-root", str(Path(tmp) / "cuda")]))
            cpu = macro_placement_test.main(
                args + ["--device", "cpu", "--output-root", str(Path(tmp) / "cpu")])
        finally:
            register_fake_client(None)
        launches = counts["fused_compose"]
        drafts = sorted(p.relative_to(card) for p in card.glob(
            "iteration_*/final_product/draft_macro_iter_*.png"))
        if launches <= 0 or not drafts:
            raise AssertionError(f"[ui] reference CLI: K1 launched {launches} times, "
                                 f"{len(drafts)} drafts")
        for d in drafts:
            if (card / d).read_bytes() != (cpu / d).read_bytes():
                raise AssertionError(f"[ui] reference CLI draft {d}: cuda != cpu")
            lay = json.loads((card / d).parents[1].joinpath(
                "layout_json", f"layout_macro_iter_{d.name[-6:-4]}.json").read_text())
            got = np.asarray(Image.open(card / d))
            pil = _pil_compose(bundle, Image.new("RGBA", (got.shape[1], got.shape[0]),
                                                 color + (255,)), lay["placements"])
            if not np.array_equal(got, np.asarray(pil)):
                raise AssertionError(f"[ui] reference CLI draft {d} != PIL")
    print(f"[ui] compat.macro_placement_test.main, squarespace 9:16, fake client, 1 "
          f"refinement: {len(drafts)} draft(s), --device cuda byte-equal to --device cpu, "
          f"== PIL (max abs err 0); K1 launched {launches} times on {smi}")
    return launches


#: [install]'s child: one composite_exact on the card from the copied
#: package, its plain version on the CPU, the launch count and the library
INSTALL_CHILD = """
import json, sys
import numpy as np, torch
from PIL import Image
from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.ops import _build, compose_kernels as ck
from image_transformation_tpu_torch.ops.compose import composite_exact

bundle = load_bundle(sys.argv[1])
canvas = np.array(Image.new("RGBA", (657, 369), (200, 120, 40, 255)))
oids = sorted(bundle.objects)
pad_h = max(bundle.objects[o].size[1] for o in oids)
pad_w = max(bundle.objects[o].size[0] for o in oids)
objs = np.zeros((len(oids), pad_h, pad_w, 4), np.uint8)
hw = np.zeros((len(oids), 2), np.int32)
boxes = np.zeros((len(oids), 4), np.int32)
for i, oid in enumerate(oids):  # scales 0.5, 0.75, 1 and 1.25 (an upscale)
    a = np.asarray(bundle.objects[oid].convert("RGBA"))
    objs[i, :a.shape[0], :a.shape[1]] = a
    hw[i] = a.shape[:2]
    w, h = (v * (i + 2) // 4 + 1 for v in bundle.objects[oid].size)
    boxes[i] = [40 * i, 15 * i, 40 * i + w, 15 * i + h]
args = lambda dev: (torch.from_numpy(canvas.copy()).to(dev), torch.from_numpy(objs).to(dev))
ck.reset_launch_counts()
card = composite_exact(*args("cuda"), hw, boxes).cpu().numpy()
torch.cuda.synchronize()
launches = ck.LAUNCHES["fused_compose"]
plain = composite_exact(*args("cpu"), hw, boxes).numpy()
np.save(sys.argv[2] + "/card.npy", card)
np.save(sys.argv[2] + "/plain.npy", plain)
np.save(sys.argv[2] + "/boxes.npy", boxes)
print(json.dumps({"launches": launches, "library": str(_build.library_path()),
                  "build_dir": str(_build.build_dir()),
                  "nvcc_s": _build.last_build_seconds,
                  "module": ck.__file__}))
"""


def phase_install(smi: str) -> int:
    """The package outside a checkout: a copy with no pyproject.toml above
    it, run in a subprocess with its own HOME; the kernels build into that
    HOME's cache, and K1's result == its plain version == PIL."""
    import numpy as np
    from PIL import Image

    from image_transformation_tpu_torch.core.bundle import load_bundle

    with tempfile.TemporaryDirectory(prefix="chip_smoke_install_") as tmp:
        tree, home, out = Path(tmp) / "site", Path(tmp) / "home", Path(tmp) / "out"
        shutil.copytree(PACKAGE, tree / PACKAGE.name,
                        ignore=shutil.ignore_patterns("__pycache__"))
        home.mkdir()
        out.mkdir()
        env = dict(os.environ, HOME=str(home), PYTHONPATH=str(tree))
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", INSTALL_CHILD,
                            str(ROOT / "data" / "squarespace"), str(out)],
                           cwd=tree, env=env, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"[install] the copied package failed ({r.returncode}):\n"
                                 f"{r.stdout}\n{r.stderr}")
        info = json.loads(r.stdout.strip().splitlines()[-1])
        cache = home / ".cache" / "image_transformation_tpu_torch" / "kernels"
        library = Path(info["library"])
        if Path(info["build_dir"]) != cache or library.parent != cache or not library.is_file():
            raise AssertionError(f"[install] the library is not under the HOME cache: {info}")
        if not Path(info["module"]).is_relative_to(tree):
            raise AssertionError(f"[install] the child imported {info['module']}, not the copy")
        card, plain = np.load(out / "card.npy"), np.load(out / "plain.npy")
        bundle = load_bundle(ROOT / "data" / "squarespace")
        placements = [{"object_id": oid, "box": [int(v) for v in box]}
                      for oid, box in zip(sorted(bundle.objects), np.load(out / "boxes.npy"))]
        pil = np.asarray(_pil_compose(bundle, Image.new("RGBA", (657, 369), (200, 120, 40, 255)),
                                      placements))
        if info["launches"] <= 0 or not np.array_equal(card, plain) \
                or not np.array_equal(card, pil):
            raise AssertionError(f"[install] K1 launched {info['launches']} times, == plain "
                                 f"{np.array_equal(card, plain)}, == PIL "
                                 f"{np.array_equal(card, pil)}")
    print(f"[install] the package copied outside a checkout (HOME and PYTHONPATH of its own): "
          f"nvcc {info['nvcc_s']:.2f}s into $HOME/.cache/image_transformation_tpu_torch/"
          f"kernels/{library.name}, composite_exact on the card == K1's plain version == PIL "
          f"(max abs err 0, 657x369, {len(placements)} placements), K1 launched "
          f"{info['launches']} times; {seconds:.1f}s in all on {smi}")
    return info["launches"]


#: [roofline]: the bench workload's batch, the reps of each timed step, the
#: sub-phases' deadlines (s; each far above its time on the card, so only a
#: stall trips one), the largest share a count may read (above it the count
#: exceeds the work) and how far the live-memory model may fall short
ROOFLINE_B = 256
ROOFLINE_REPS = 20
ROOFLINE_DEADLINES = {"inputs": 60, "model": 300, "memory": 120, "timed": 180, "report": 60}
SHARE_LIMIT = 1.05
LIVE_SHORTFALL = 0.10


def row_shares(kernel, row1, batched, variants_k2, hybrid, ops_rows, row15, luma, gradient,
               campaign):
    """(kernel-table row, kernel, geometry, result) of every row's timed
    geometry in the phases above, each result with ``ms`` and its bound."""
    rows = [("12", "K1", f"row12_{g}", kernel[g]) for g in kernel]
    rows += [("1", "K1", f"row1_{g}", row1[g]) for g in row1]
    rows += [("13", "K2", "sweep_1080p_b64", batched["fused_v3"]),
             ("13", "K2", f"variants_1080p_v{WIDE_V}", variants_k2),
             ("14", "K3", "sweep_1080p_b64", batched["restore_windows"])]
    rows += [(r[3:], "K4", "1080p_b64", v) for r, v in {**hybrid, **ops_rows}.items()]
    rows += [("15", "K4 stage", v, r) for v, r in row15["variants"].items()]
    rows.append(("16", "luma", f"score1080_b{ROOFLINE_B}", luma))
    rows += [("13", "K2", "uhd_gradient_b256", gradient["fused_v3"]),
             ("13", "K2 resample", "uhd_gradient_b256", gradient["fused_v3_resample"]),
             ("13", "K2 tables", "uhd_gradient_b256", gradient["fused_v3_tables"]),
             ("17", "K3 ramp", "uhd_horizontal_b256", gradient["restore_horizontal"]),
             ("17", "K3 ramp", "uhd_vertical_b256", gradient["restore_vertical"])]
    rows += [("17" if g.startswith("restore") else "13",
              "K3 lines" if g.startswith("restore") else "K2 own objects", f"campaign_{g}_b64", r)
             for g, r in campaign.items()]
    return rows


def _step_report(label, model, work, ms, raw, name, smi):
    """Print one timed step's roofline and return its share of the bound."""
    from image_transformation_tpu_torch.ops import roofline
    from image_transformation_tpu_torch.ops import roofline_compute as rc

    bps = 1e3 / ms
    roof = roofline.summarize(model, bps, name)
    comp = rc.summarize_compute(work, bps, name, hbm_bytes_per_batch=model["total_bytes"])
    bnd = roofline.bound(model["total_bytes"], work["int_macs"], work["scalar_ops"], name)
    share = bnd["bound_ms"] / ms
    print(f"[roofline] {label} step: {ms:.4f} ms ({', '.join(f'{t:.4f}' for t in raw)}; median "
          f"CUDA-event ms of {ROOFLINE_REPS} reps after a warm-up, in turns), "
          f"{ROOFLINE_B * bps:.1f} canvases/s; bytes by term {json.dumps(roof['model_bytes_per_batch'])}; "
          f"{_bound_text(bnd)}; share of the bound {share:.5f} on {smi}")
    print(f"[roofline] {label} summarize: {json.dumps(roof)}")
    print(f"[roofline] {label} summarize_compute: {json.dumps(comp)}")
    return share, bnd["l2_resident"]


def phase_roofline(smi: str, rows) -> dict:
    """The bench workload's step against its work model, every row's share
    of its bound, and the live-memory model against the allocator's peak,
    under the watchdog."""
    import numpy as np
    import torch

    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.core.watchdog import PhaseWatchdog
    from image_transformation_tpu_torch.ops import compose_kernels as ck
    from image_transformation_tpu_torch.ops import roofline
    from image_transformation_tpu_torch.ops import roofline_compute as rc
    from image_transformation_tpu_torch.parallel.sweep import (
        make_solid_render_step,
        random_downscale_boxes,
    )

    def on_stall(payload):
        print(f"[roofline] stalled in sub-phase {payload['stalled_phase']!r} after "
              f"{payload['elapsed_s']} s (deadline {payload['deadline_s']} s): "
              f"{json.dumps(payload, default=str)}", flush=True)
        sys.stderr.flush()

    H, W = BATCH_HW
    B = ROOFLINE_B
    name = torch.cuda.get_device_name(0)
    device = torch.device("cuda", 0)
    wd = PhaseWatchdog(on_stall, context={"batch": B, "canvas_hw": [H, W], "device_name": name})
    try:
        wd.phase("inputs", ROOFLINE_DEADLINES["inputs"])
        arrays = load_bundle(ROOT / "data" / "squarespace").to_arrays()
        N, pad = arrays.obj_hw.shape[0], tuple(arrays.objects.shape[1:3])
        static = tuple(tuple(int(v) for v in row) for row in arrays.obj_hw)
        rng = np.random.default_rng(0)
        boxes = np.stack([random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(B)])
        hw = np.broadcast_to(arrays.obj_hw, (B, N, 2)).copy()

        wd.phase("model", ROOFLINE_DEADLINES["model"])
        t0 = time.perf_counter()
        models = {reuse: roofline.solid_render_bytes_per_batch(
            B, N, (H, W), pad, static_obj_hw=static, shared_objs=True, reuse=reuse,
            stat="fence", boxes=boxes, objects=arrays) for reuse in (True, False)}
        work = rc.solid_render_compute_per_batch(arrays.obj_hw, boxes, (H, W), pad,
                                                 static_obj_hw=static)
        live = roofline.expected_live_hbm_bytes(B, N, (H, W), pad, shared_objs=True)
        wd.update_context(expected_live_hbm_bytes=live)
        print(f"[roofline] squarespace {H}x{W} B={B} N={N} shared planar objects, stat fence: "
              f"work counted in {time.perf_counter() - t0:.2f} s (host tables, once per "
              f"geometry); operations by stage {json.dumps(work['stages'])} (multiply-adds of "
              f"the two passes, alpha-over operations of the blend); card {name!r}, L2 "
              f"{torch.cuda.get_device_properties(0).L2_cache_size} bytes, table "
              f"{roofline.card_peaks(name)}")

        wd.phase("memory", ROOFLINE_DEADLINES["memory"])
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        objs_p = ck.planarize_objects(torch.from_numpy(arrays.objects).to(device)[None])
        hw_d, boxes_d = (torch.from_numpy(x).to(device) for x in (hw, boxes))
        step = make_solid_render_step((H, W), pad, static_obj_hw=static, stat="fence",
                                      device="cuda")
        ck.reset_launch_counts()
        for _ in range(2):  # fresh, then reuse
            step(None, objs_p, hw_d, boxes_d)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        launches = {k: ck.LAUNCHES[k] for k in ("fused_v3", "restore_windows")}
        if launches != {"fused_v3": 2, "restore_windows": 1}:
            raise AssertionError(f"[roofline] a fresh and a reuse step launched {launches}")
        print(f"[roofline] live memory: predicted {live['total_bytes']:.0f} bytes "
              f"({json.dumps(live)}), measured peak allocated {peak} bytes around the step's "
              f"construction and two steps (fresh, then reuse; launches {launches}); predicted / "
              f"measured {live['total_bytes'] / peak:.4f} on {smi}")
        if live["total_bytes"] < (1 - LIVE_SHORTFALL) * peak:
            raise AssertionError(f"[roofline] live-memory model {live['total_bytes']:.0f} is under "
                                 f"the measured peak {peak} by more than {LIVE_SHORTFALL:.0%}")

        wd.phase("timed", ROOFLINE_DEADLINES["timed"])
        fresh = make_solid_render_step((H, W), pad, static_obj_hw=static, stat="fence",
                                       reuse=False, device="cuda")
        steps = {"reuse": lambda: step(None, objs_p, hw_d, boxes_d),
                 "fresh": lambda: fresh(None, objs_p, hw_d, boxes_d)}
        times = {k: [] for k in steps}
        for k in ("reuse", "fresh", "fresh", "reuse"):
            times[k].append(cuda_ms(steps[k], ROOFLINE_REPS))
        step.release()
        del step, fresh, steps

        wd.phase("report", ROOFLINE_DEADLINES["report"])
        out = {"live_predicted": live["total_bytes"], "live_measured": peak}
        for label, reuse in (("reuse", True), ("fresh", False)):
            share, l2 = _step_report(label, models[reuse], work, min(times[label]),
                                     times[label], name, smi)
            out[label] = dict(ms=min(times[label]), share=share)
            if share > SHARE_LIMIT and not l2:
                raise AssertionError(f"[roofline] the {label} step reads {share:.3f} of its "
                                     f"bound: the count exceeds the work")
        over = []
        for row, kern, geometry, r in rows:
            share = r["bound_ms"] / r["ms"]
            print(f"[roofline] row {row} ({kern}) {geometry}: bound {r['bound_ms']:.4f} ms by "
                  f"{r['bound_by']} / {r['ms']:.4f} ms measured = share {share:.4f}"
                  f"{' (L2-resident: not an HBM share)' if r['l2_resident'] else ''}")
            if share > SHARE_LIMIT and not r["l2_resident"]:
                over.append(f"row {row} {geometry} {share:.3f}")
        if over:
            raise AssertionError(f"[roofline] shares above {SHARE_LIMIT}: {over}")
        print(f"[roofline] {len(rows)} row geometries, none above {SHARE_LIMIT} outside L2; "
              f"on {smi}")
    finally:
        wd.done()
    return out


_CONTRACT = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def _entry(name: str, source: str, replaces: str, launches: int, main: dict, **extra):
    """One kernel's line entry: the contract's keys (times and bound from
    ``main``, the geometry its ``ms`` is measured at) and ``extra``."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, **{k: main[k] for k in _CONTRACT}, **extra}


def main_smoke() -> int:
    smi = phase_device()
    import torch

    phase_build()
    kernel = phase_kernel(smi)
    launches = phase_main_path()
    batched, batched_launches, _ = phase_batched(smi)
    luma = phase_luma(smi)
    gradient, gradient_launches = phase_gradient(smi)
    campaign, campaign_launches = phase_campaign(smi)
    hybrid, hybrid_launches, ref = phase_hybrid(smi)
    ops_rows, row1, row15 = phase_ops(smi, ref)
    del ref
    variants_k2, variants_launches = phase_variants(smi)
    serving_launches = phase_serving(smi)
    agentic_launches = phase_agentic(smi)
    mesh_launches = phase_mesh(smi)
    ui_launches = phase_ui(smi)
    install_launches = phase_install(smi)
    phase_roofline(smi, row_shares(kernel, row1, batched, variants_k2, hybrid, ops_rows, row15,
                                   luma, gradient, campaign))
    cli, serve = kernel["cli_9x16_b1"], kernel["serve_1080p_b64"]
    packed = {**hybrid, **{k: v for k, v in ops_rows.items() if k != "row2"}}
    print(f"[kernels] {LIBRARY_NOTE}")
    print(json.dumps({"kernels": [
        _entry("fused_compose", KERNEL_SOURCE,
               f"{KERNEL_REPLACES} (kernel-table row 12), {KERNEL_REPLACES_ROW1}",
               launches["fused_compose"] + sum(r["launches"] for r in row1.values())
               + serving_launches["fused_compose"] + agentic_launches
               + mesh_launches["fused_compose"] + ui_launches + install_launches, cli,
               max_abs_err=max(r["max_abs_err"] for r in (cli, serve, *row1.values())),
               geometries={"row12_cli_9x16_b1": cli, "row12_1080p_b64": serve,
                           **{f"row1_{k}": v for k, v in row1.items()}}),
        _entry("fused_v3", V3_SOURCE, V3_REPLACES,
               batched_launches["fused_v3"] + variants_launches + serving_launches["fused_v3"]
               + mesh_launches["fused_v3"] + gradient_launches["fused_v3"]
               + campaign_launches["fused_v3"],
               batched["fused_v3"],
               max_abs_err=max(batched["fused_v3"]["max_abs_err"], variants_k2["max_abs_err"],
                               gradient["fused_v3"]["max_abs_err"],
                               *(r["max_abs_err"] for g, r in campaign.items()
                                 if g.startswith("fused_v3"))),
               chunks_uhd_gradient=gradient_launches["fused_v3_chunks"],
               fused_v3_tables=gradient_launches["fused_v3_tables"],
               geometries={"sweep_1080p_b64": batched["fused_v3"],
                           f"variants_1080p_v{WIDE_V}": variants_k2,
                           "uhd_gradient_b256": gradient["fused_v3"],
                           "uhd_gradient_b256_resample": gradient["fused_v3_resample"],
                           "uhd_gradient_b256_tables": gradient["fused_v3_tables"],
                           **{f"campaign_{g}_b64": r for g, r in campaign.items()
                              if g.startswith("fused_v3")}}),
        _entry("restore_windows", RESTORE_SOURCE, RESTORE_REPLACES,
               batched_launches["restore_windows"] + gradient_launches["restore_windows"]
               + campaign_launches["restore_windows"],
               batched["restore_windows"],
               max_abs_err=max(r["max_abs_err"] for r in (batched["restore_windows"],
                                                          gradient["restore_horizontal"],
                                                          gradient["restore_vertical"],
                                                          *(r for g, r in campaign.items()
                                                            if g.startswith("restore")))),
               geometries={"sweep_1080p_b64": batched["restore_windows"],
                           "row17_uhd_horizontal_b256": gradient["restore_horizontal"],
                           "row17_uhd_vertical_b256": gradient["restore_vertical"],
                           **{f"row17_campaign_{g}_b64": r for g, r in campaign.items()
                              if g.startswith("restore")}}),
        # the default clamped form (row 6); every row's numbers follow
        _entry("window_blend", BLEND_SOURCE, BLEND_REPLACES,
               hybrid_launches + sum(ops_rows[k]["launches"] for k in packed if k in ops_rows),
               hybrid["row6"],
               max_abs_err=max(r["max_abs_err"] for r in packed.values()), rows=packed),
        _entry("window_blend_planar", BLEND_SOURCE, PLANAR_REPLACES,
               ops_rows["row2"]["launches"], ops_rows["row2"]),
        _entry("window_blend_stage", BLEND_SOURCE, STAGE_REPLACES, row15["launches"],
               row15["variants"]["full"],
               max_abs_err=max(r["max_abs_err"] for r in row15["variants"].values()),
               variants=row15["variants"]),
        _entry("packed_luma", LUMA_SOURCE, LUMA_REPLACES,
               batched_launches["packed_luma"] + luma["launches"], luma),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main_smoke())
    except Exception:
        traceback.print_exc()
        print(f"[device] at the failure: {ecc_line()}", file=sys.stderr)
        sys.exit(1)
