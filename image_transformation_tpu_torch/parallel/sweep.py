"""Batched rendering: the batched compose step, the solid and gradient
render steps and the throughput sweep.

Port of image_transformation_tpu/parallel/sweep.py (:29-385, :476-704).
The JAX module's fallback chain (gen-3 -> gen-2 -> clamped -> XLA, with
latched tiers, ``fallback_mode``, ``step.fallback`` and ``precompile``) is
a TPU/JAX mechanism and collapses here to one rule: on a CUDA device a
``kernel="pallas"`` step runs the gen-3 kernels (K2, and K3 on reuse) or
raises; on the CPU it runs their plain versions. ``kernel="xla"`` is JAX's
XLA step, which runs no kernel: the plain compose
(``ops.compose.composite_batch``) on the given device. The device is
explicit: each factory takes a ``device`` (default ``cuda``), and asking
for CUDA without a card raises.

The multi-GPU forms take a :class:`~.mesh.Mesh` (one process per GPU) and
run on its device: :func:`sharded_compose_step` (the plain compose on
each rank's canvases, as JAX's XLA step), :func:`make_sharded_solid_render`
(K2 per rank), :func:`sharded_compose_many` (the serving merge, K1 per
rank) and ``throughput_sweep(mesh=)``. Each takes the global batch, keeps
its rank's shard, and reduces the run-level luminance over the ``data``
ranks with one all-reduce (JAX's ``pmean``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.timing import span
from ..ops.compose import composite_batch, composite_canvas_tables_indexed_many
from ..ops.compose_kernels import (
    composite_batch_fused_v3,
    gradient_axis,
    gradient_ramp,
    pack_rgba_scalar,
    packed_luma,
    planarize_objects,
    render_fused_v3_step,
    render_geometry,
    render_solid_fused_v3_program,
)

from .mesh import Mesh, Sharding, shard_batched

KERNELS = ("xla", "pallas")
STATS = ("luma", "fence")


def _check_kernel(kernel: str) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")


def _check_stat(stat: str) -> None:
    if stat not in STATS:
        raise ValueError(f"stat must be one of {STATS}, got {stat!r}")


def _on(x, dev: torch.device) -> torch.Tensor:
    """``x`` as a tensor on ``dev`` (host arrays are copied)."""
    return x.to(dev) if torch.is_tensor(x) else torch.from_numpy(np.array(x)).to(dev)


def _luma_u8(out_u8: torch.Tensor) -> torch.Tensor:
    """Per-canvas Rec.709 luminance of u8 RGBA [B, H, W, 4], f32:
    ``packed_luma`` of the int32 view of the bytes, or of a contiguous copy
    where that view would not be a packed crop (a pixel's four bytes not
    adjacent, pixels not 4 bytes apart, or rows not on 4-byte words)."""
    px = out_u8
    if (px.stride(-1) != 1 or px.stride(-2) != 4 or px.storage_offset() % 4
            or any(s % 4 for s in px.stride()[:-2])):
        px = px.clone(memory_format=torch.contiguous_format)
    return packed_luma(px.view(torch.int32).squeeze(-1))


def make_batched_compose(
    out_max_hw: Tuple[int, int],
    kernel: str = "xla",
    static_obj_hw: Optional[Tuple[Tuple[int, int], ...]] = None,
    device: str = "cuda",
):
    """Step ``(canvases [B,H,W,4], objs [B,N,Hm,Wm,4], obj_hw, boxes) ->
    (composed u8 [B,H,W,4], mean luminance [B])``.

    ``kernel`` takes the JAX package's values. "xla" is JAX's XLA step
    (``composite_canvas`` under vmap, no Pallas): the plain compose
    ``ops.compose.composite_batch``, which crops a box larger than
    ``out_max_hw`` at the envelope. "pallas" is JAX's tier 0, the gen-3
    compose (:func:`composite_batch_fused_v3`): K2 on a CUDA device, its
    plain version on the CPU; gen-3 clamps an oversized box's target size
    to its window and so renders another scale. The two agree on boxes
    that fit the envelope. Inputs are moved to ``device``.
    """
    _check_kernel(kernel)
    dev = resolve_device(device)

    def step(canvases, objs, obj_hw, boxes):
        args = (_on(canvases, dev), _on(objs, dev), _on(obj_hw, dev), _on(boxes, dev))
        if kernel == "xla":
            out = composite_batch(*args, out_max_hw)
        else:
            out = composite_batch_fused_v3(*args, out_max_hw, static_obj_hw=static_obj_hw)
        return out, _luma_u8(out)

    return step


batched_compose_step = make_batched_compose
"""Alias kept for the public parallel API."""


def _render_step(canvas_hw, out_max_hw, background, out_bounds_hw, reuse: bool, stat: str,
                 dev: torch.device):
    """The batched render step on the background that ``background(geometry)``
    gives (a packed solid colour, or a gradient ramp of the geometry's
    padded plane): the core that :func:`make_solid_render_step` and
    :func:`make_gradient_render_step` share, so that the background is all
    that differs between them. The render geometry is decided on the first
    call (the envelope from its objects' shape where ``out_max_hw`` is None,
    their count from it where there are no bounds) and kept: later calls
    take objects of the same shape, shared ([1, N, ...]) or one creative
    per canvas ([B, N, ...]). Each reuse call restores the windows the
    previous call's meta drew."""
    H, W = canvas_hw
    fixed: List = [None]  # (geometry, background), decided on the first call
    state: List = [None]  # (plane, meta) of the previous call

    def run_stat(plane):
        if stat == "fence":
            return plane[:, 0, :128].sum(dim=1, dtype=torch.int64).to(torch.int32)
        return packed_luma(plane[:, :H, :W])

    def step(canvases, objs, obj_hw, boxes):
        del canvases  # the background is made on the device
        with span("itx.step"):
            objs = _on(objs, dev)
            objs_p = objs if objs.shape[4] != 4 else planarize_objects(objs)
            obj_hw = _on(obj_hw, dev)
            boxes = _on(boxes, dev)
            if fixed[0] is None:
                out_hw = objs_p.shape[3:] if out_max_hw is None else out_max_hw
                geo = render_geometry((H, W), out_hw, objs_p.shape[1], out_bounds_hw,
                                      pipelined=True)
                fixed[0] = geo, background(geo)
            geo, bg = fixed[0]
            with span("itx.render", dev):
                plane, meta = render_fused_v3_step(geo, objs_p, obj_hw, boxes, bg, state[0])
            if reuse:
                state[0] = (plane, meta)
            with span("itx.stat", dev):
                return plane, run_stat(plane)

    step.release = lambda: state.__setitem__(0, None)
    return step


def make_solid_render_step(
    canvas_hw: Tuple[int, int],
    out_max_hw: Tuple[int, int],
    bg_rgba: Tuple[int, int, int, int] = (128, 128, 128, 255),
    static_obj_hw: Optional[Tuple[Tuple[int, int], ...]] = None,
    reuse: bool = True,
    stat: str = "luma",
    device: str = "cuda",
):
    """Solid-background render step: ``step(canvases, objs, obj_hw, boxes)
    -> (plane, stat)``, the signature of :func:`make_batched_compose`'s
    steps. ``canvases`` is ignored (the background is made on the device);
    ``plane`` is the padded packed int32 plane [B, hp, wp], whose bytes
    crop to RGBA (``packed_to_u8(plane)[:, :H, :W]``). ``objs`` may be u8
    [Bo, N, ph, pw, 4] or planar, with Bo == 1 shared by the B canvases of
    ``boxes``, or Bo == B, one creative per canvas (K2 reads canvas b's
    objects from ``objs[b]``); ``obj_hw`` [B, N, 2] gives each canvas's
    sizes, and a slot of size (0, 0), where a creative has fewer objects
    than N, draws and restores nothing. The render runs with the JAX step's
    settings (pipelined, per-object windows when ``static_obj_hw`` is
    given).

    ``static_obj_hw``: per-object bounds (h, w) of the output sizes, which
    size each object's K2 window and restore window (the asset sizes bound
    every downscale-only layout). A box past its bound renders at the size
    the window clamps it to, another scale than the box's;
    :func:`make_gradient_render_step` takes the bounds as ``out_bounds_hw``.

    ``stat``: "luma" is each canvas's mean Rec.709 luminance of the crop
    (the sweep's run statistic); "fence" is ``sum(plane[:, 0, :128])`` as
    int32, a 512-byte-per-canvas read that proves the render ran.

    With ``reuse=True`` (default) each call after the first restores only
    the windows the previous call drew (K3) and composes IN PLACE on the
    previous call's plane: the ``plane`` a call returns is overwritten by
    the next call. A caller that keeps planes passes ``reuse=False`` or
    copies them; ``step.release()`` drops the kept plane.
    """
    _check_stat(stat)
    bg = pack_rgba_scalar(bg_rgba)
    return _render_step(canvas_hw, out_max_hw, lambda geo: bg, static_obj_hw, reuse, stat,
                        resolve_device(device))


def make_gradient_render_step(
    canvas_hw: Tuple[int, int],
    out_bounds_hw: Tuple[Tuple[int, int], ...],
    gradient: Tuple,
    reuse: bool = True,
    stat: str = "luma",
    device: str = "cuda",
):
    """Gradient-background render step: the step of
    :func:`make_solid_render_step` (signature, reuse in place, ``stat``,
    ``step.release()``, objects shared or one creative per canvas: ``objs``
    [1 or B, N, ...]) on the c1 -> c2 gradient ``gradient = (c1, c2,
    horizontal)``, as ``ops.background.gradient_spec`` gives it (the
    upstream fill_gradient); or on a gradient per canvas, ``c1`` and ``c2``
    u8 [B, 3] and ``horizontal`` a bool or one per canvas. The gradients of
    a batch run on one axis: both axes raise ValueError. The gradient's
    packed lines (:func:`ops.compose_kernels.gradient_ramp`, one line or a
    line per canvas) are built once, with the step's geometry on its first
    call; each reuse call restores the previous call's windows from them
    (K3's ramp form), and a count of lines other than the batch's raises.

    ``out_bounds_hw``: per-object bounds (h, w) of the output sizes, one per
    object. Their maximum is K2's output envelope (its scratch and the
    plane's pad), and each sizes its object's K2 window and restore window,
    so that upscaled boxes render and restore in full. An envelope past the
    objects' padded extent also gives K2's growing axes tables from exact
    tap arguments, within 2 units of 2^22 of Pillow's. A box larger than
    its bound renders at the size its window clamps it to (each side cut to
    its bound rounded up to 8 rows and 128 columns): the object at another
    scale than the box's, anchored at the box's origin, with no error
    raised (the check would cost a sync a step).
    """
    _check_stat(stat)
    dev = resolve_device(device)
    bounds = tuple((int(h), int(w)) for h, w in out_bounds_hw)
    if not bounds or min(min(b) for b in bounds) < 1:
        raise ValueError(f"out_bounds_hw must be positive (h, w) pairs, got {out_bounds_hw}")
    envelope = (max(h for h, _ in bounds), max(w for _, w in bounds))
    c1, c2, horizontal = gradient
    horizontal = gradient_axis(horizontal)
    return _render_step(canvas_hw, envelope,
                        lambda geo: gradient_ramp(c1, c2, horizontal, canvas_hw, geo.pad, dev),
                        bounds, reuse, stat, dev)


def _batch_mean(mesh: Mesh, luma: torch.Tensor, total: int) -> torch.Tensor:
    """The mean of the per-canvas ``luma`` over the mesh's ``data`` ranks,
    [1] float32: one all-reduce of the local sum."""
    s = luma.sum(dtype=torch.float32).reshape(1)
    return mesh.all_reduce_sum(s, "data") / total


def sharded_compose_step(
    mesh: Mesh,
    out_max_hw: Tuple[int, int],
    spatial: bool = False,
):
    """Multi-GPU batched compose (JAX sweep.py:388): ``step(canvases, objs,
    obj_hw, boxes) -> (this rank's composed canvases, mean luminance [1])``.

    The arguments are the global batch (host arrays or tensors); each rank
    composes its ``data`` shard with the plain compose on ``mesh.device``
    (JAX's XLA step runs no kernel), and with ``spatial`` returns its band
    of canvas rows (the height must divide over ``spatial``; the rank
    composes its canvases whole and keeps the band). The luminance is the
    batch mean over the whole mesh (an all-reduce over ``data``)."""
    batch = shard_batched(mesh)
    band = Sharding(mesh, (None, "spatial"))  # rows of this rank's canvases
    dev = mesh.device

    def step(canvases, objs, obj_hw, boxes):
        total = canvases.shape[0]
        local = [_on(batch.local(x), dev) for x in (canvases, objs, obj_hw, boxes)]
        out = composite_batch(*local, out_max_hw)
        luma = _batch_mean(mesh, _luma_u8(out), total)
        return (band.local(out).contiguous() if spatial else out), luma

    return step


def make_sharded_solid_render(
    mesh: Mesh,
    canvas_hw: Tuple[int, int],
    out_max_hw: Tuple[int, int],
    bg_rgba: Tuple[int, int, int, int] = (128, 128, 128, 255),
    static_obj_hw: Optional[Tuple[Tuple[int, int], ...]] = None,
):
    """Multi-GPU one-program solid render (JAX sweep.py:423): the gen-3
    render (K2 on a CUDA device, its plain version on the CPU) runs on each
    rank's ``data`` shard, and the run-level mean luminance is one
    all-reduce over ``data`` (JAX's ``pmean``).

    ``step(objs_p [1 or B, N, 4, ph, pw], obj_hw [B, N, 2], boxes
    [B, N, 4]) -> (this rank's padded packed planes [B / data, hp, wp],
    global luma [1])``. The arguments are global; objects with a leading 1
    are shared by every canvas, as the single-GPU render takes them."""
    from ..ops.compose_kernels import pack_rgba_scalar

    H, W = canvas_hw
    bg = pack_rgba_scalar(bg_rgba)
    batch = shard_batched(mesh)
    dev = mesh.device

    def step(objs_p, obj_hw, boxes):
        total = boxes.shape[0]
        objs_p = _on(objs_p if objs_p.shape[0] == 1 else batch.local(objs_p), dev)
        out = render_solid_fused_v3_program(
            objs_p, _on(batch.local(obj_hw), dev), _on(batch.local(boxes), dev),
            (H, W), bg, out_max_hw, static_obj_hw=static_obj_hw,
        )
        return out, _batch_mean(mesh, packed_luma(out[:, :H, :W]), total)

    return step


def sharded_compose_many(mesh: Mesh, canvas_u8, objs_all, perm, boxes, kh_i32, kv_i32,
                         same_size) -> torch.Tensor:
    """The serving merge with its batch split over the ``data`` ranks: each
    rank runs ``ops.compose.composite_canvas_tables_indexed_many`` (K1 over
    its canvases on a CUDA device) on its shard of the placement sets.

    ``canvas_u8`` and ``objs_all`` are shared; ``perm``, ``boxes``,
    ``kh_i32``, ``kv_i32`` and ``same_size`` carry the global merge batch
    (leading dim B). Returns this rank's uint8 [B / data, H, W, 4]."""
    batch = shard_batched(mesh)
    dev = mesh.device
    return composite_canvas_tables_indexed_many(
        _on(canvas_u8, dev), _on(objs_all, dev),
        *(_on(batch.local(x), dev) for x in (perm, boxes, kh_i32, kv_i32, same_size)),
    )


def random_downscale_boxes(
    rng: np.random.Generator,
    obj_hw: np.ndarray,
    canvas_hw: Tuple[int, int],
) -> np.ndarray:
    """Solver-realistic random placements (downscale-only, inside canvas)."""
    n = obj_hw.shape[0]
    H, W = canvas_hw
    boxes = np.zeros((n, 4), np.int32)
    for k in range(n):
        oh, ow = int(obj_hw[k, 0]), int(obj_hw[k, 1])
        if oh == 0 or ow == 0:
            continue
        s = float(rng.uniform(0.3, 1.0))
        s = min(s, H / oh, W / ow, 1.0)
        w, h = max(1, int(ow * s)), max(1, int(oh * s))
        x1 = int(rng.integers(0, max(1, W - w)))
        y1 = int(rng.integers(0, max(1, H - h)))
        boxes[k] = (x1, y1, x1 + w, y1 + h)
    return boxes


def _fence(stat: torch.Tensor) -> None:
    """Wait for the step that produced ``stat`` (a device-to-host copy)."""
    stat.cpu()


def throughput_sweep(
    bundles,
    ratios: List[str],
    batch_per_ratio: int,
    pixel_budget_size: Optional[Tuple[int, int]] = None,
    mesh=None,
    spatial: bool = False,
    warmup: int = 1,
    reps: int = 3,
    seed: int = 0,
    kernel: str = "xla",
    superbatch: int = 0,
    device: str = "cuda",
) -> Dict:
    """Bundles x ratios end-to-end composites/sec (JAX sweep.py:498).

    ``bundles`` is a list of core.bundle.Bundle; they pad to one shared
    envelope. Per ratio: B = ``batch_per_ratio`` canvases with random
    downscale boxes from ``seed``. ``kernel="pallas"`` runs the solid
    render step (fresh render, then reuse renders: K2 + K3 on a CUDA
    device) on shared planar objects made once, and on the CPU their plain
    versions; ``kernel="xla"`` runs the batched compose step on uploaded
    solid canvases (the plain compose, as JAX's "xla" sweep times XLA with
    no Pallas). ``superbatch=K`` (pallas
    only): each rep is K reuse steps over K box sets. Warm-up reps
    (``warmup``, and for pallas one more so the reuse path is warm too)
    end in a fence each; the timed region is ``reps`` reps and one fence
    on the last stat. Returns the timing and throughput per ratio and
    overall.

    With ``mesh`` (JAX's mesh branch, sweep.py:563) every rank runs
    :func:`sharded_compose_step` on its ``data`` shard of the B canvases
    (``spatial``: and its band of rows) on ``mesh.device``; ``kernel``,
    ``superbatch`` and ``device`` are not used, and the timing is this
    rank's.
    """
    from ..layout.canvas import compute_canvas_size

    _check_kernel(kernel)
    dev = mesh.device if mesh is not None else resolve_device(device)
    rng = np.random.default_rng(seed)
    n_max = max(len(b.meta) for b in bundles)
    pad_h = max(m.height for b in bundles for m in b.meta.values())
    pad_w = max(m.width for b in bundles for m in b.meta.values())
    arrays = [b.to_arrays(n_max=n_max, pad_hw=(pad_h, pad_w)) for b in bundles]
    # per-object-index static size cover across bundles (exact sizes when
    # there is one bundle)
    hw_cover = np.maximum.reduce([a.obj_hw for a in arrays])
    static_hw = tuple(tuple(int(v) for v in row) for row in hw_cover)

    results = {"ratios": {}, "total_canvases": 0, "total_seconds": 0.0}
    for ratio in ratios:
        if pixel_budget_size is not None:
            W, H = compute_canvas_size(pixel_budget_size, ratio, verbose=False)
        else:
            W, H = compute_canvas_size(bundles[0].background.size, ratio, verbose=False)
        B = batch_per_ratio
        objs = np.zeros((B, n_max, pad_h, pad_w, 4), np.uint8)
        hw = np.zeros((B, n_max, 2), np.int32)
        boxes = np.zeros((B, n_max, 4), np.int32)
        for i in range(B):
            arr = arrays[i % len(arrays)]
            objs[i] = arr.objects
            hw[i] = arr.obj_hw
            boxes[i] = random_downscale_boxes(rng, arr.obj_hw, (H, W))
        hw_d = torch.from_numpy(hw).to(dev)

        if mesh is not None:
            # JAX's mesh sweep: the sharded plain compose over uploaded
            # solid canvases, whatever ``kernel`` says
            canvases = np.zeros((B, H, W, 4), np.uint8)
            canvases[..., :3] = 128
            canvases[..., 3] = 255
            mesh_step = sharded_compose_step(mesh, (pad_h, pad_w), spatial=spatial)

            def rep():
                return mesh_step(canvases, objs, hw, boxes)[1]

            warm = max(1, warmup)
            k_steps = 0
            per_rep = B
        elif kernel == "pallas":
            # one bundle: every canvas has the same objects, shared as [1, N]
            objs_in = objs[:1] if len(arrays) == 1 else objs
            objs_p = planarize_objects(torch.from_numpy(objs_in).to(dev))
            step = make_solid_render_step((H, W), (pad_h, pad_w),
                                          static_obj_hw=static_hw, device=str(dev))
            k_steps = max(1, superbatch)
            box_sets = [torch.from_numpy(boxes).to(dev)] + [
                torch.from_numpy(np.stack([
                    random_downscale_boxes(rng, hw[i], (H, W)) for i in range(B)
                ])).to(dev)
                for _ in range(k_steps - 1)
            ]

            def rep():
                for bx in box_sets:
                    _, stat = step(None, objs_p, hw_d, bx)
                return stat

            warm = max(1, warmup) + 1  # the second call is the first reuse
            per_rep = B * k_steps
        else:
            canvases = torch.full((B, H, W, 4), 128, dtype=torch.uint8, device=dev)
            canvases[..., 3] = 255
            args = (canvases, torch.from_numpy(objs).to(dev), hw_d,
                    torch.from_numpy(boxes).to(dev))
            xla_step = make_batched_compose((pad_h, pad_w), kernel=kernel,
                                            device=str(dev))

            def rep():
                return xla_step(*args)[1]

            warm = max(1, warmup)
            k_steps = 0
            per_rep = B
        for _ in range(warm):
            _fence(rep())
        t0 = time.perf_counter()
        for _ in range(reps):
            stat = rep()
        _fence(stat)
        dt = time.perf_counter() - t0
        results["ratios"][ratio] = {
            "canvas": [W, H],
            "batch": B,
            "superbatch": k_steps if superbatch > 1 else 0,
            "seconds_per_batch": dt / reps / max(1, k_steps),
            "canvases_per_sec": per_rep * reps / dt,
        }
        results["total_canvases"] += per_rep * reps
        results["total_seconds"] += dt
    results["canvases_per_sec"] = (
        results["total_canvases"] / results["total_seconds"]
        if results["total_seconds"] else 0.0
    )
    return results


__all__ = [
    "batched_compose_step",
    "make_batched_compose",
    "make_gradient_render_step",
    "make_sharded_solid_render",
    "make_solid_render_step",
    "random_downscale_boxes",
    "sharded_compose_many",
    "sharded_compose_step",
    "throughput_sweep",
]
