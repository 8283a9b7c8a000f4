#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and nvcc.
Phases, each printing its own lines; any failure raises and the script
exits non-zero:

1. device: nvidia-smi name and power limit, torch/CUDA versions, Pillow;
   exits 1 at once when torch.cuda.is_available() is False;
2. build: compiles csrc/*.cu with nvcc (timed);
3. kernel vs plain version: K1 (ops/compose_kernels.fused_compose) against
   fused_compose_reference on the card, bit-exact (tolerance 0), at the
   CLI geometry (squarespace at 9:16, B=1) and the batched serving
   geometry (squarespace objects shared, 1080x1920, B=64, boxes from
   seed 0), with median CUDA-event times of both;
4. main path: the port CLI's main() with --device cuda --api fake
   --refine-iters 2 on squarespace 9:16 and audio_book 16:9. K1 launch
   counts are reset just before and read just after; every draft must
   equal the CPU plain engine's compose of its layout JSON and PIL's own
   LANCZOS resize + alpha_composite;
5. batched path (squarespace objects shared, 1080x1920): K2
   (ops/compose_kernels.fused_v3) against fused_v3_reference at B=64 with
   boxes from seed 0 and per-object static windows, and K3
   (restore_windows) against restore_windows_reference, both bit-exact
   (tolerance 0), with median CUDA-event times of both; a 3-step reuse
   chain (K3 + K2 in place) equal to fresh renders; then the main path of
   the slice, throughput_sweep(kernel="pallas") at 1080p B=256 with
   warmup 1 and 5 reps, with the K2/K3 launch counts reset just before and
   read just after (both must be > 0), printing canvases/s;
6. hybrid path (squarespace, 1080x1920, B=64, boxes from seed 0 plus an
   identity box and the edge box of benchmarks/validate_hw.py:100): for
   each clamped x pipelined form of composite_batch_hybrid_packed, K4
   (ops/compose_kernels.window_blend) against window_blend_reference on
   that form's producer outputs, bit-exact, with median CUDA-event times
   of both and of the producer; then the form itself, with the K4 launch
   count reset just before and read just after (must be > 0), equal to
   the port's composite_batch on the card; the packed_out plane's bytes
   equal the u8 output; 4 canvases within 2/255 of PIL's own LANCZOS
   resize + alpha_composite;
7. one JSON line of kernel results, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
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
                  ":1907 (kernel-table rows 3, 5, 6, 10)")
#: (name, clamped, pipelined): the four forms K4 replaces, by kernel-table row
HYBRID_FORMS = (("row3", False, False), ("row5", False, True),
                ("row6", True, False), ("row10", True, True))
BATCH_HW = (1080, 1920)
HYBRID_B = 64


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


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
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        print(f"[kernel] {name}: canvas {hw[0]}x{hw[1]} B={batch} "
              f"N={objects.shape[1]} pad {objects.shape[2]}x{objects.shape[3]}: "
              f"K1 == plain (max abs err {err}, {changed} pixels composed); "
              f"K1 {ms:.3f} ms ({k1:.3f}, {k2:.3f}), plain {plain_ms:.3f} ms "
              f"({p1:.3f}, {p2:.3f}) on {smi}")
        del canvas, objects, tables, out_k, out_p, work_k, work_p
        torch.cuda.empty_cache()
    return results


def _pil_draft(bundle, canvas_png: Path, placements):
    """PIL's own compose: LANCZOS resize + alpha_composite, list order."""
    from PIL import Image

    canvas = Image.open(canvas_png).convert("RGBA")
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


def phase_batched(smi: str):
    import numpy as np
    import torch

    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.ops import compose_kernels as ck
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
    meta, env, (hp, wp) = ck._render_meta(objs_p, hw, boxes(0), (H, W), None, True, static)
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
    results["fused_v3"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    print(f"[batched] K2 canvas {H}x{W} (plane {hp}x{wp}) B={B} N={N} shared objects, "
          f"static windows: K2 == plain (max abs err {err}, {changed} pixels changed); "
          f"K2 {ms:.3f} ms ({raw[0]:.3f}, {raw[1]:.3f}), plain {plain_ms:.3f} ms "
          f"({raw[2]:.3f}, {raw[3]:.3f}) on {smi}")
    del work_k, work_p

    # K3 vs its plain version: restore the windows of that render
    static_win = ck._static_window_extents(static, env)
    origins = ck._restore_meta_static(boxes(0), (H, W), (hp, wp), static_win)
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
    results["restore_windows"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    print(f"[batched] K3 B={B} N={N} per-object windows {list(static_win)}: K3 == plain "
          f"(max abs err {err}) and leaves the solid plane; K3 {ms:.3f} ms "
          f"({raw[0]:.3f}, {raw[1]:.3f}), plain {plain_ms:.3f} ms "
          f"({raw[2]:.3f}, {raw[3]:.3f}) on {smi}")
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
    for name in ("fused_v3", "restore_windows"):
        if launches[name] <= 0:
            raise AssertionError(f"[batched] the sweep launched {name} {launches[name]} times")
    r = sweep["ratios"]["16:9"]
    if tuple(r["canvas"]) != (W, H) or not r["canvases_per_sec"] > 0:
        raise AssertionError(f"[batched] unexpected sweep result {sweep}")
    print(f"[batched] throughput_sweep squarespace 16:9 {r['canvas'][0]}x{r['canvas'][1]} "
          f"B={r['batch']} pallas warmup 1 reps 5: {r['canvases_per_sec']:.1f} canvases/s "
          f"({r['seconds_per_batch'] * 1e3:.3f} ms per batch); launches K2 "
          f"{launches['fused_v3']}, K3 {launches['restore_windows']} on {smi}")
    return results, launches, sweep


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
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, producer_ms=producer_ms)
        print(f"[hybrid] {name} (clamped={clamped}, pipelined={pipelined}) plane "
              f"{plane_hw[0]}x{plane_hw[1]}: K4 == plain (max abs err {err}, "
              f"{changed} pixels changed); K4 {ms:.3f} ms "
              f"({raw[0]:.3f}, {raw[1]:.3f}), plain {plain_ms:.3f} ms ({raw[2]:.3f}, "
              f"{raw[3]:.3f}), producer {producer_ms:.3f} ms; compose == composite_batch, "
              f"K4 launches {launches} on {smi}")
        torch.cuda.empty_cache()

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
    return results, total_launches


def main_smoke() -> int:
    smi = phase_device()
    import torch

    phase_build()
    kernel = phase_kernel(smi)
    launches = phase_main_path()
    batched, batched_launches, _ = phase_batched(smi)
    hybrid, hybrid_launches = phase_hybrid(smi)
    cli, serve = kernel["cli_9x16_b1"], kernel["serve_1080p_b64"]
    print(json.dumps({"kernels": [{
        "name": "fused_compose",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches["fused_compose"],
        "max_abs_err": max(cli["max_abs_err"], serve["max_abs_err"]),
        "ms": cli["ms"],
        "plain_ms": cli["plain_ms"],
        "ms_1080p_b64": serve["ms"],
        "plain_ms_1080p_b64": serve["plain_ms"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": batched_launches[name],
        **batched[name],
    } for name, source, replaces in (
        ("fused_v3", V3_SOURCE, V3_REPLACES),
        ("restore_windows", RESTORE_SOURCE, RESTORE_REPLACES),
    )] + [{
        "name": "window_blend",
        "route": "cuda",
        "source": BLEND_SOURCE,
        "replaces": BLEND_REPLACES,
        "launches": hybrid_launches,
        "max_abs_err": max(r["max_abs_err"] for r in hybrid.values()),
        # the default clamped form (row 6); every form's times follow
        "ms": hybrid["row6"]["ms"],
        "plain_ms": hybrid["row6"]["plain_ms"],
        "forms": hybrid,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main_smoke())
