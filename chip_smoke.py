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
5. one JSON line of kernel results, the nvidia-smi line, and last
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


def main_smoke() -> int:
    smi = phase_device()
    import torch

    phase_build()
    kernel = phase_kernel(smi)
    launches = phase_main_path()
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
