#!/usr/bin/env python3
"""Scaling of the multi-GPU paths over the ranks of a torchrun world.

    torchrun --nproc-per-node N -m tools.profile_mesh [--backend nccl] [--device cuda]

Run from the root of a checkout, one process per card (each rank on
cuda:LOCAL_RANK; rank 0 builds the kernels first, with chip_smoke.py's
build phase). For the world of N ranks, rank 0 prints:

- the sharded solid render (``make_sharded_solid_render``, K2 per rank) at
  1080x1920 with B = 256 canvases in all (squarespace objects shared, boxes
  from ``random_downscale_boxes`` seed 0): each rank's ms per step (host
  clock over ``--reps`` steps back to back, ending in a synchronize; each
  step ends in the luma all-reduce), the slowest rank's, and the mesh's
  canvases/s (B over the slowest rank's step); the all-reduce of one float
  alone (median ms);
- the fleet on the mesh (``run_fleet(mesh=)``, kernel "pallas") over both
  bundles x 8 ratios at a 1920x1080 pixel budget, ``--reps`` passes per
  bundle after a warm-up: ms per pass of each bundle (rank 0's clock) and
  canvases/s;

then one JSON line with the same numbers, the card's name and nvidia-smi's
name and power limit. ``--device cpu --backend gloo`` runs the same on the
CPU (no kernel; for a rehearsal of the control flow, at the sizes given).
"""

from __future__ import annotations

import argparse
import json
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke

RATIOS = chip_smoke.VARIANT_RATIOS


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _per_step_ms(fn, reps: int, dev) -> float:
    """ms per call of ``fn`` over ``reps`` calls back to back (after one
    warm-up call), ending in one synchronize."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return 1e3 * (time.perf_counter() - t0) / reps


def _wh(text: str):
    a, b = text.lower().split("x")
    return int(a), int(b)


def main(argv=None) -> None:
    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.ops import compose_kernels as ck
    from image_transformation_tpu_torch.parallel.mesh import make_mesh
    from image_transformation_tpu_torch.parallel.sweep import (
        make_sharded_solid_render,
        random_downscale_boxes,
    )
    from image_transformation_tpu_torch.pipeline.fleet import run_fleet

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--backend", default="nccl", choices=["nccl", "gloo"])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--hw", default="1080x1920", help="solid render canvas HxW")
    parser.add_argument("--batch", type=int, default=256, help="solid render canvases in all")
    parser.add_argument("--budget", default="1920x1080", help="fleet pixel budget WxH")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)

    mesh = make_mesh(device=args.device, backend=args.backend)
    dev = mesh.device
    smi = chip_smoke.smi_line() if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        if mesh.rank == 0:
            chip_smoke.phase_build()
        mesh.barrier()
    try:
        H, W = _wh(args.hw)
        B = args.batch
        arrays = load_bundle(chip_smoke.ROOT / "data" / "squarespace").to_arrays()
        n = arrays.obj_hw.shape[0]
        rng = np.random.default_rng(0)
        boxes = np.stack([random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(B)])
        hw = np.broadcast_to(arrays.obj_hw, (B, n, 2)).copy()
        objs_p = ck.planarize_objects(torch.from_numpy(arrays.objects).to(dev)[None])
        step = make_sharded_solid_render(mesh, (H, W), arrays.objects.shape[1:3])
        boxes_d = torch.from_numpy(boxes).to(dev)
        hw_d = torch.from_numpy(hw).to(dev)
        step_ms = _per_step_ms(lambda: step(objs_p, hw_d, boxes_d), args.reps, dev)
        every = [float(t) for t in mesh.all_gather(torch.tensor([step_ms], device=dev))]
        one = torch.zeros(1, device=dev)
        reduce_ms = []
        for _ in range(args.reps):
            _sync(dev)
            t0 = time.perf_counter()
            mesh.all_reduce_sum(one, "data")
            _sync(dev)
            reduce_ms.append(1e3 * (time.perf_counter() - t0))
        solid = {"canvas": [H, W], "batch": B, "per_rank": B // mesh.size(),
                 "step_ms_by_rank": every, "step_ms": max(every),
                 "canvases_per_sec": B / (max(every) / 1e3),
                 "all_reduce_ms": statistics.median(reduce_ms)}
        bundles = [chip_smoke.ROOT / "data" / "squarespace", chip_smoke.ROOT / "data" / "audio_book"]
        with tempfile.TemporaryDirectory(prefix="profile_mesh_") as empty:
            # an empty output root: no earlier run's layout is picked up
            fleet = run_fleet(bundles, RATIOS, mesh=mesh, save=False, reps=args.reps,
                              pixel_budget_size=_wh(args.budget), kernel="pallas",
                              output_root=Path(empty))
        fleet_out = {"budget": list(_wh(args.budget)), "ratios": len(RATIOS),
                     "ms_per_pass": {k: 1e3 * v["seconds_per_pass"]
                                     for k, v in fleet["bundles"].items()},
                     "canvases_per_sec": fleet["canvases_per_sec_device"]}
    finally:
        mesh.close()
    if mesh.rank != 0:
        return
    tag = f"[mesh-profile] world {mesh.size()} ({args.backend})"
    print(f"{tag} sharded solid render {H}x{W} B={B} ({B // mesh.size()} per rank): step "
          f"{', '.join(f'{t:.3f}' for t in every)} ms by rank, slowest {max(every):.3f} ms, "
          f"{solid['canvases_per_sec']:.1f} canvases/s; all-reduce (1 float) "
          f"{solid['all_reduce_ms']:.3f} ms on {smi}")
    print(f"{tag} fleet 2 bundles x {len(RATIOS)} ratios at {args.budget}, pallas, reps "
          f"{args.reps}: " + ", ".join(f"{k} {v:.3f} ms per pass"
                                       for k, v in fleet_out["ms_per_pass"].items())
          + f", {fleet_out['canvases_per_sec']:.1f} canvases/s on {smi}")
    print(json.dumps({"world": mesh.size(), "backend": args.backend,
                      "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                      "smi": smi, "solid": solid, "fleet": fleet_out}))


if __name__ == "__main__":
    main()
