"""Rank side of tests/test_torch_mesh.py: one world of 4 gloo ranks on the
CPU runs every mesh case of the port and rank 0 saves the results.

This module imports only numpy, torch and the port (no jax): with the
``spawn`` start method every rank imports it afresh.
"""

from __future__ import annotations

import pickle
import traceback
from pathlib import Path

import numpy as np

H_MAX, W_MAX = 32, 64
PAD_H, PAD_W = 16, 16
N_OBJ = 3
WORLD = 4
BG = np.array([30, 60, 90], np.uint8)
BG_GRAD = np.array([[200, 40, 10], [15, 90, 230]], np.uint8)
BUNDLES = ("data/squarespace", "data/audio_book")
FLEET_RATIOS = ("9:16", "1:1", "16:9")  # 3 variants: ragged over 4 ranks
FLEET_BUDGET = (160, 90)
SWEEP_BUDGET = (64, 48)


def workload():
    """The multichip workload (tests/test_multichip_deep.py:31-67):
    (root, objs, obj_wh, known)."""
    root = {"type": "flex", "direction": "column",
            "children": [{"object_id": i + 1, "name": f"o{i + 1}"} for i in range(N_OBJ)]}
    rng = np.random.default_rng(7)
    objs = rng.integers(0, 256, (N_OBJ, PAD_H, PAD_W, 4), dtype=np.uint8)
    obj_wh = np.array([[12, 8], [16, 10], [6, 6]], np.int32)
    for k, (w, h) in enumerate(obj_wh):
        objs[k, h:, :] = 0
        objs[k, :, w:] = 0
    return root, objs, obj_wh, np.ones((N_OBJ,), bool)


def mixed_sizes(v: int) -> np.ndarray:
    """Every variant a different (W, H)."""
    wh = np.tile(np.array([[W_MAX, H_MAX]], np.int32), (v, 1))
    for i in range(v):
        wh[i, 0] = W_MAX - 4 * (i % 5)
        wh[i, 1] = H_MAX - 2 * (i % 3)
    return wh


def solid_batch(objs, obj_wh, b: int):
    """Dry-run step 2's batch: (objs [B, N, ph, pw, 4], hw [B, N, 2],
    boxes [B, N, 4]), with B // 2 canvases of a second bundle (step 6)."""
    objs_b = np.broadcast_to(objs, (b, *objs.shape)).copy()
    hw = np.broadcast_to(obj_wh[:, ::-1], (b, N_OBJ, 2)).astype(np.int32).copy()
    boxes = np.broadcast_to(np.array(
        [[2, 2, 10, 8], [20, 8, 30, 16], [40, 20, 46, 26]], np.int32), (b, N_OBJ, 4)).copy()
    rng = np.random.default_rng(7)
    objs2 = rng.integers(0, 256, objs.shape, dtype=np.uint8)
    wh2 = np.array([[10, 12], [8, 6], [14, 9]], np.int32)
    for k, (w, h) in enumerate(wh2):
        objs2[k, h:, :] = 0
        objs2[k, :, w:] = 0
    mixed = (objs_b.copy(), hw.copy(), boxes.copy())
    mixed[0][b // 2:] = objs2
    mixed[1][b // 2:] = wh2[:, ::-1]
    mixed[2][b // 2:] = np.array([[1, 1, 10, 12], [18, 6, 23, 13], [36, 18, 45, 26]], np.int32)
    return (objs_b, hw, boxes), mixed


def merge_sets(b: int):
    """Dry-run step 7's placement sets (seed 11), ragged in length."""
    rng = np.random.default_rng(11)
    _, _, obj_wh, _ = workload()
    sets = []
    for i in range(b):
        ps = []
        for k, oid in enumerate((1, 2, 3)):
            ow, oh = (int(v) for v in obj_wh[k])
            w, h = int(rng.integers(1, ow + 1)), int(rng.integers(1, oh + 1))
            x1, y1 = int(rng.integers(0, W_MAX - w)), int(rng.integers(0, H_MAX - h))
            ps.append({"object_id": oid, "box": [x1, y1, x1 + w, y1 + h]})
        sets.append(ps[: 1 + i % 3])
    return sets


def merge_canvas():
    canvas = np.zeros((H_MAX, W_MAX, 4), np.uint8)
    canvas[..., :3] = 128
    canvas[..., 3] = 255
    return canvas


def _cases(tmp: Path):
    """Yield (name, thunk) of every case; each thunk returns what rank 0
    saves (numpy arrays and plain values)."""
    import torch

    from image_transformation_tpu_torch.core.bundle import BundleArrays, load_bundle
    from image_transformation_tpu_torch.layout.solve import FlexProgram
    from image_transformation_tpu_torch.ops.compose_kernels import planarize_objects
    from image_transformation_tpu_torch.parallel import mesh as pm
    from image_transformation_tpu_torch.parallel import sweep
    from image_transformation_tpu_torch.pipeline.engine import ComposeEngine
    from image_transformation_tpu_torch.pipeline.fleet import run_fleet
    from image_transformation_tpu_torch.pipeline.fused import (
        make_sharded_fused_render,
        pad_ragged_variants,
    )

    root, objs, obj_wh, known = workload()
    prog = FlexProgram.from_dsl(root)
    kw = dict(device="cpu", backend="gloo")

    def errors():
        out = {}
        for name, fn in (
            ("data3", lambda: pm.make_mesh(data=3, **kw)),
            ("slices3", lambda: pm.make_slice_mesh(slices=3, **kw)),
            ("slice3x2", lambda: pm.make_slice_mesh(slices=3, data=2, **kw)),
            ("spatial_dim0", lambda: pm.shard_batched(pm.make_mesh(**kw), spatial_dim=0)),
            ("nccl_on_cpu", lambda: pm.make_mesh(device="cpu", backend="nccl")),
        ):
            try:
                fn()
                out[name] = None
            except ValueError as e:
                out[name] = str(e)
        meshes = {"default": pm.make_mesh(**kw), "spatial2": pm.make_mesh(spatial=2, **kw),
                  "slice": pm.make_slice_mesh(**kw)}
        out["shapes"] = {k: [list(m.dim_names), list(m.shape)] for k, m in meshes.items()}
        return out

    def fused(mesh, v, masked=False, **opts):
        wh = mixed_sizes(v)
        args = [wh, opts.pop("bg", BG), objs, obj_wh, known]
        if masked:
            wh, valid = pad_ragged_variants(wh, mesh.size(opts.get("batch_axes", "data")))
            args[0] = wh
            args.append(valid)
        step = make_sharded_fused_render(mesh, prog, (H_MAX, W_MAX), (PAD_H, PAD_W),
                                         masked=masked, **opts)
        out, boxes, luma = step(*args)
        axes = tuple(opts.get("batch_axes", ("data",)))
        axes = axes if len(axes) > 1 else axes[0]
        spatial_dim = 1 if opts.get("spatial") else None
        return {"out": pm.shard_batched(mesh, spatial_dim, axes).gather(out).numpy(),
                "boxes": pm.shard_batched(mesh, None, axes).gather(boxes).numpy(),
                "luma": luma.numpy()}

    data4 = pm.make_mesh(**kw)
    data2 = pm.make_mesh(spatial=2, **kw)
    slices = pm.make_slice_mesh(**kw)
    (objs_b, hw_b, boxes_b), mixed = solid_batch(objs, obj_wh, WORLD * 2)

    def solid(batch, **opts):
        step = sweep.make_sharded_solid_render(data4, (H_MAX, W_MAX), (PAD_H, PAD_W), **opts)
        objs_p = planarize_objects(torch.from_numpy(batch[0]))
        out, luma = step(objs_p, batch[1], batch[2])
        return {"out": pm.shard_batched(data4).gather(out).numpy(), "luma": luma.numpy()}

    def merge():
        arrays = BundleArrays(objects=objs, obj_hw=obj_wh[:, ::-1].astype(np.int32).copy(),
                              object_ids=np.array([1, 2, 3], np.int32), n_valid=N_OBJ)
        engine = ComposeEngine(arrays, merge_canvas(), torch.device("cpu"))
        lives = [engine.validate_placements(ps) for ps in merge_sets(WORLD * 2)]
        per = [engine.indexed_args_np(live, N_OBJ) for live in lives]
        stacked = [np.stack([a[i] for a in per]) for i in range(5)]
        out = sweep.sharded_compose_many(data4, merge_canvas(), objs, *stacked)
        return {"out": pm.shard_batched(data4).gather(out).numpy(),
                "stacked": stacked,
                "engine": np.stack([engine.compose(live).numpy() for live in lives])}

    def compose_step(mesh, spatial):
        (objs_c, hw_c, boxes_c), _ = solid_batch(objs, obj_wh, WORLD * 2)
        canvases = np.zeros((WORLD * 2, H_MAX, W_MAX, 4), np.uint8)
        canvases[..., :3] = (20, 140, 200)
        canvases[..., 3] = 255
        out, luma = sweep.sharded_compose_step(mesh, (PAD_H, PAD_W), spatial=spatial)(
            canvases, objs_c, hw_c, boxes_c)
        return {"out": pm.shard_batched(mesh, 1 if spatial else None).gather(out).numpy(),
                "luma": luma.numpy()}

    def throughput():
        bundles = [load_bundle(b) for b in BUNDLES]
        r = sweep.throughput_sweep(bundles, ["1:1", "16:9"], WORLD, SWEEP_BUDGET, mesh=data4,
                                   warmup=0, reps=1)
        return {k: v for k, v in r.items() if k != "ratios"} | {
            "ratios": {k: {kk: vv for kk, vv in v.items() if kk in ("canvas", "batch", "superbatch")}
                       for k, v in r["ratios"].items()}}

    def fleet(kernel):
        s = run_fleet([Path(b) for b in BUNDLES], FLEET_RATIOS, output_root=tmp / f"fleet_{kernel}",
                      mesh=data4, pixel_budget_size=FLEET_BUDGET, kernel=kernel)
        return {"devices": s["devices"], "total_canvases": s["total_canvases"],
                "canvas_sizes": {k: v["canvas_sizes"] for k, v in s["bundles"].items()}}

    yield "mesh_errors", errors
    yield "fused_data4", lambda: fused(data4, 8)
    yield "fused_data4_pallas", lambda: fused(data4, 8, kernel="pallas")
    yield "fused_data2_spatial2", lambda: fused(data2, 4, spatial=True)
    yield "fused_slice2_data2", lambda: fused(slices, 8, batch_axes=("slice", "data"))
    yield "fused_ragged6_data4", lambda: fused(data4, 6, masked=True)
    yield "fused_ragged6_slice", lambda: fused(slices, 6, masked=True,
                                              batch_axes=("slice", "data"))
    yield "fused_gradient_data4", lambda: fused(data4, 8, bg=BG_GRAD, background="gradient")
    yield "solid_data4", lambda: solid((objs_b, hw_b, boxes_b))
    yield "solid_static_data4", lambda: solid(
        (objs_b, hw_b, boxes_b), static_obj_hw=tuple((int(h), int(w)) for w, h in obj_wh))
    yield "solid_two_bundles", lambda: solid(mixed)
    yield "merge_data4", merge
    yield "compose_step_data4", lambda: compose_step(data4, False)
    yield "compose_step_spatial2", lambda: compose_step(data2, True)
    yield "sweep_data4", throughput
    yield "fleet_data4_xla", lambda: fleet("xla")
    yield "fleet_data4_pallas", lambda: fleet("pallas")


def run(rank: int, tmp: str) -> None:
    """One rank: initialise gloo over a file store in ``tmp``, run every
    case (each rank runs all, as SPMD code does), rank 0 pickles the
    results to ``results.pkl``; a case that raises is saved as its
    traceback."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    tmp = Path(tmp)
    # a case that raised on one rank only would leave the others waiting
    # in a collective: the store's timeout ends them
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    results = {}
    for name, thunk in _cases(tmp):
        try:
            results[name] = thunk()
        except Exception:  # noqa: BLE001 - reported per case by the test
            results[name] = {"error": traceback.format_exc()}
    if rank == 0:
        with open(tmp / "results.pkl", "wb") as f:
            pickle.dump(results, f)
    dist.destroy_process_group()


def run_card(rank: int, tmp: str, world: int, backend: str) -> None:
    """One rank on cuda:0 (the card tests): gloo over a file store for a
    world of 2, or make_mesh's own world of one for nccl. The solid render
    (K2), the sharded fused render ("pallas", K2) and the merge (K1) each
    run with the launch counts reset just before and read just after, then
    their single-GPU counterparts; the rank pickles the counts and the
    comparisons to ``card_<rank>.pkl``."""
    import datetime

    import torch
    import torch.distributed as dist

    from image_transformation_tpu_torch.core.bundle import BundleArrays
    from image_transformation_tpu_torch.layout.solve import FlexProgram
    from image_transformation_tpu_torch.ops import compose_kernels as ck
    from image_transformation_tpu_torch.parallel import mesh as pm
    from image_transformation_tpu_torch.parallel import sweep
    from image_transformation_tpu_torch.pipeline.engine import ComposeEngine
    from image_transformation_tpu_torch.pipeline.fused import (
        make_fused_render,
        make_sharded_fused_render,
    )

    tmp = Path(tmp)
    dev = torch.device("cuda", 0)
    if world > 1:
        dist.init_process_group(backend, init_method=f"file://{tmp / 'store'}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=120))
    mesh = pm.make_mesh(device=dev, backend=backend)
    root, objs, obj_wh, known = workload()
    b = 4 * world
    (objs_b, hw_b, boxes_b), _ = solid_batch(objs, obj_wh, b)
    res = {"backend": mesh.backend, "world": mesh.size()}

    def counted(fn):
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(ck.LAUNCHES)

    objs_p = ck.planarize_objects(torch.from_numpy(objs_b).to(dev))
    render = sweep.make_sharded_solid_render(mesh, (H_MAX, W_MAX), (PAD_H, PAD_W))
    (plane, luma), res["solid_launches"] = counted(lambda: render(objs_p, hw_b, boxes_b))
    whole = ck.render_solid_fused_v3_program(objs_p, torch.from_numpy(hw_b).to(dev),
                                             torch.from_numpy(boxes_b).to(dev), (H_MAX, W_MAX),
                                             ck.pack_rgba_scalar((128, 128, 128, 255)),
                                             (PAD_H, PAD_W))
    res["solid_equal"] = bool(torch.equal(plane, pm.shard_batched(mesh).local(whole)))
    res["solid_luma"] = (float(luma[0]),
                         float(ck.packed_luma(whole[:, :H_MAX, :W_MAX]).mean()))

    prog = FlexProgram.from_dsl(root)
    wh = mixed_sizes(2 * world)
    step = make_sharded_fused_render(mesh, prog, (H_MAX, W_MAX), (PAD_H, PAD_W), kernel="pallas")
    (out, boxes, _), res["fused_launches"] = counted(lambda: step(wh, BG, objs, obj_wh, known))
    single = make_fused_render(prog, (H_MAX, W_MAX), (PAD_H, PAD_W), kernel="pallas")(
        *(torch.from_numpy(x).to(dev) for x in (wh, BG, objs, obj_wh, known)))
    batch = pm.shard_batched(mesh)
    res["fused_equal"] = bool(torch.equal(out, batch.local(single[0]))
                              and torch.equal(boxes, batch.local(single[1])))

    arrays = BundleArrays(objects=objs, obj_hw=obj_wh[:, ::-1].astype(np.int32).copy(),
                          object_ids=np.array([1, 2, 3], np.int32), n_valid=N_OBJ)
    engine = ComposeEngine(arrays, merge_canvas(), dev)
    lives = [engine.validate_placements(ps) for ps in merge_sets(b)]
    per = [engine.indexed_args_np(live, N_OBJ) for live in lives]
    stacked = [np.stack([a[i] for a in per]) for i in range(5)]
    merged, res["merge_launches"] = counted(
        lambda: sweep.sharded_compose_many(mesh, merge_canvas(), objs, *stacked))
    mine = batch.local(np.arange(b))
    res["merge_equal"] = all(torch.equal(merged[j], engine.compose(lives[i]))
                             for j, i in enumerate(mine))
    with open(tmp / f"card_{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    mesh.close()
    if dist.is_initialized():
        dist.destroy_process_group()
