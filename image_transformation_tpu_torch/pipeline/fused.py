"""Multi-ratio fused render: layout solve + background + compose + statistic
for V canvas sizes in one device pass.

Port of image_transformation_tpu/pipeline/fused.py. Aspect-ratio variants
share one step by rendering onto a padded superset canvas (h_max, w_max)
with each variant's actual (W, H) as data: the tensor solver
(layout/solve.py) takes the [V, 2] canvas sizes, the compose takes the
solved boxes, the background is a broadcast (solid) or a per-variant ramp
(gradient). The crop to each variant's true size happens at artifact time.

``kernel`` takes the JAX package's values. "xla" is JAX's XLA step: the
solve and the plain compose (``ops.compose.composite_canvas``) per
variant, no kernel. "pallas" is JAX's gen-3 step: the solve, the packed
plane and K2 (``ops.compose_kernels.fused_v3``) over one shared planar
object copy, which on a CUDA device launches the kernel (or raises) and on
the CPU runs its plain version. Both paint into the padded canvas, so they
return the same padded renders within the traced tables' envelope. The
device is that of the step's tensors; the entry points take ``device``
(default "cuda", which raises without a card). Nothing falls back to
another kernel or device.

:func:`make_sharded_fused_render` runs the same step on each rank of a
``parallel.mesh.Mesh`` (one process per GPU) over its shard of the
variants, with the run's luminance reduced by one all-reduce.

The resample is LANCZOS, the one filter of the port's gen-3 tables.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..layout.solve import FlexProgram, solve_program
from ..ops.compose import composite_canvas
from ..ops.compose_kernels import (
    fused_v3,
    packed_luma_masked,
    packed_to_u8,
    planarize_objects,
    render_geometry,
)

KERNELS = ("xla", "pallas")
BACKGROUNDS = ("solid", "gradient")
_OPAQUE = -(1 << 24)  # alpha 255 in the top byte of a signed packed pixel


def _pack_rgb(rgb_u8: torch.Tensor) -> torch.Tensor:
    """Opaque packed RGBA int32 of u8 [..., 3] (little-endian bytes)."""
    c = rgb_u8.to(torch.int32)
    return c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16) | _OPAQUE


def _make_padded_canvas(background: str, gradient_horizontal: bool,
                        canvas_max_hw: Tuple[int, int]):
    """Background synthesizer for the variants onto the padded superset.

    Returns ``padded_packed(bg, canvas_wh) -> int32 [V, h_max, w_max]``,
    packed opaque RGBA. "solid": bg u8 [3] broadcast. "gradient": bg u8
    [2, 3]; the linear c1 -> c2 ramp spans each variant's TRUE extent along
    the (static) axis, with the weights computed as (denom - i) / denom and
    i / denom over a per-variant float32 ``denom`` (each division rounds
    the exact rational once, which matches the reference's f32(1 - t_f64)
    weight to the last ulp; 1 - t loses a ulp to round-to-even ties and
    flips the truncating u8 cast), a float32 lerp and a truncating u8 cast
    saturated at 0 and 255, as XLA's (the pad extrapolates past t = 1; the
    crop discards it).
    """
    h_max, w_max = canvas_max_hw
    if background not in BACKGROUNDS:
        raise ValueError(f"unknown background mode: {background!r}")

    def padded_packed(bg, canvas_wh):
        v = canvas_wh.shape[0]
        if background == "solid":
            return _pack_rgb(bg).expand(v, h_max, w_max)
        c1f = bg[0].to(torch.float32)
        c2f = bg[1].to(torch.float32)
        span, extent = (w_max, canvas_wh[:, 0]) if gradient_horizontal else (h_max, canvas_wh[:, 1])
        denom = (extent.to(torch.float32) - 1.0).clamp(min=1.0)[:, None]  # [V, 1]
        idx = torch.arange(span, dtype=torch.float32, device=bg.device)
        t = idx / denom
        w1 = (denom - idx) / denom
        ramp = w1[..., None] * c1f + t[..., None] * c2f  # [V, span, 3]
        packed = _pack_rgb(ramp.clamp(0.0, 255.0).to(torch.uint8))
        if gradient_horizontal:
            return packed[:, None, :].expand(v, h_max, w_max)
        return packed[:, :, None].expand(v, h_max, w_max)

    return padded_packed


def map_bundle_to_program(prog: FlexProgram, bundle, arrays):
    """Bundle arrays in FlexProgram row order: (objs, obj_wh, known).

    FlexProgram rows are DSL order; the bundle tensor is id order. The ONE
    home of this mapping (fused render, fleet) — unknown object ids keep
    zero rows with known=False, exactly the compositor's skip semantics.
    Host numpy, as JAX's."""
    n = prog.n_objects
    objs = np.zeros((n, *arrays.objects.shape[1:]), np.uint8)
    obj_wh = np.zeros((n, 2), np.int32)
    known = np.zeros((n,), bool)
    size_map = bundle.sizes()
    for k, oid in enumerate(prog.obj_ids):
        oid = int(oid)
        if oid in size_map:
            objs[k] = arrays.objects[arrays.index_of(oid)]
            obj_wh[k] = size_map[oid]
            known[k] = True
    return objs, obj_wh, known


def make_fused_render(
    prog: FlexProgram,
    canvas_max_hw: Tuple[int, int],
    obj_pad_hw: Tuple[int, int],
    kernel: str = "xla",
    background: str = "solid",
    gradient_horizontal: bool = True,
    static_obj_hw: Tuple[Tuple[int, int], ...] | None = None,
):
    """Build the fused step for one layout structure.

    Returned step signature (all tensors on one device, where it runs):
        step(canvas_wh [V, 2] int32 (W, H per variant),
             bg        uint8: [3] solid color, or [2, 3] gradient (c1, c2),
             objs      [N, Hm, Wm, 4] uint8,
             obj_wh    [N, 2] int32 (w, h),
             obj_known [N] bool)
        -> (canvases [V, h_max, w_max, 4] uint8, boxes [V, N, 4] int32,
            scales [V, N] float32, luma [V] float32)

    The out-of-canvas area of each padded render is garbage by
    construction (background extrapolation); crop with the per-variant
    (W, H) before use. ``luma`` is the masked mean over each variant's
    TRUE (W, H) extent (``ops.compose_kernels.packed_luma_masked``).
    Placements are dropped and clipped against the padded (h_max, w_max)
    canvas, in both kernels.

    ``kernel="pallas"`` composes with K2 on the packed plane K2's JAX
    counterpart takes: the object envelope rounded up to (8, 128), its
    windows and plane (``ops.compose_kernels.render_geometry``), which
    decide where each object's window is cut, and ONE shared planar copy
    of the objects ([1, N, 4, ph, pw]). ``static_obj_hw`` (pallas only,
    one (h, w) cover per object) is JAX's resample specialization, which
    leaves the output bit-identical; K2 builds its tables from the sizes
    in its meta, so here it is only checked against N.
    """
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    h_max, w_max = canvas_max_hw
    padded_packed = _make_padded_canvas(background, gradient_horizontal, canvas_max_hw)
    # static_obj_hw is checked here; the windows stay the envelope's
    geo = render_geometry(canvas_max_hw, obj_pad_hw, prog.n_objects, static_obj_hw)

    def step(canvas_wh, bg, objs, obj_wh, obj_known):
        boxes, scales = solve_program(prog, canvas_wh, obj_wh, obj_known)
        hw_swapped = obj_wh.flip(-1)  # compose wants (h, w)
        base = packed_to_u8(padded_packed(bg, canvas_wh))
        out = torch.stack([
            composite_canvas(base[v], objs, hw_swapped, boxes[v], obj_pad_hw)
            for v in range(canvas_wh.shape[0])
        ])
        luma = packed_luma_masked(out.view(torch.int32).squeeze(-1), canvas_wh)
        return out, boxes, scales, luma

    if kernel != "pallas":
        return step

    hp, wp = geo.pad

    def pallas_step(canvas_wh, bg, objs, obj_wh, obj_known):
        v = canvas_wh.shape[0]
        boxes, scales = solve_program(prog, canvas_wh, obj_wh, obj_known)
        meta = geo.meta(obj_wh.flip(-1), boxes)
        if background == "solid":
            plane = _pack_rgb(bg).expand(v, hp, wp).contiguous()
        else:
            # the pad past (h_max, w_max) is zero, as JAX's plane
            plane = torch.zeros((v, hp, wp), dtype=torch.int32, device=objs.device)
            plane[:, :h_max, :w_max] = padded_packed(bg, canvas_wh)
        # ONE shared planar copy: K2 reads object row 0 for every variant
        objs_p = planarize_objects(objs[None])
        fused_v3(plane, objs_p, meta, geo.envelope)
        crop = plane[:, :h_max, :w_max]
        return packed_to_u8(crop), boxes, scales, packed_luma_masked(crop, canvas_wh)

    return pallas_step


def make_sharded_fused_render(
    mesh,
    prog: FlexProgram,
    canvas_max_hw: Tuple[int, int],
    obj_pad_hw: Tuple[int, int],
    spatial: bool = False,
    batch_axes: Tuple[str, ...] = ("data",),
    masked: bool = False,
    background: str = "solid",
    gradient_horizontal: bool = True,
    kernel: str = "xla",
):
    """Multi-GPU fused step (JAX fused.py:260): the variants shard over the
    mesh's ``batch_axes``, the object tensors are whole on every rank, and
    the global mean luminance is one all-reduce.

    The per-variant core is :func:`make_fused_render`'s step (its
    ``kernel``: "xla", JAX's sharded step, or "pallas", K2 on a CUDA
    device), so single-GPU and sharded semantics agree by construction.

    ``step(canvas_wh [V, 2], bg, objs, obj_wh, obj_known[, valid [V]])``
    takes the GLOBAL arguments on every rank (host arrays or tensors) and
    returns (this rank's canvases [V / batch, h_max (/ spatial), w_max, 4]
    uint8, its boxes [V / batch, N, 4], the global luma [1] float32), all
    on ``mesh.device``. ``batch_axes`` is ``("data",)``, or
    ``("slice", "data")`` on a slice mesh (the reduction then crosses both
    dims). With ``spatial`` a rank keeps its band of ``h_max /
    mesh.size("spatial")`` canvas rows (it renders its variants whole);
    V must divide over the batch ranks and h_max over ``spatial``, as
    JAX's shardings require. ``masked=True`` adds ``valid``: ragged
    variant counts pad up to the mesh (:func:`pad_ragged_variants`) and the
    luma is ``sum(luma * w) / max(1, sum(w))``, both sums reduced in one
    all-reduce. ``shard_batched(mesh, batch_axes=..., spatial_dim=1 with
    spatial).gather`` (``parallel.mesh``) assembles the global canvases.
    """
    from ..parallel.mesh import Sharding, shard_batched

    axes = tuple(batch_axes) if len(batch_axes) > 1 else batch_axes[0]
    batch = shard_batched(mesh, batch_axes=axes)
    band = Sharding(mesh, (None, "spatial"))  # rows of this rank's variants
    if spatial and canvas_max_hw[0] % mesh.size("spatial"):
        raise ValueError(f"dimension 1 of size {canvas_max_hw[0]} is not divisible by the "
                         f"mesh's ('spatial',) extent {mesh.size('spatial')}")
    core = make_fused_render(prog, canvas_max_hw, obj_pad_hw, kernel=kernel,
                             background=background, gradient_horizontal=gradient_horizontal)
    dev = mesh.device

    def on(x):
        return x.to(dev) if torch.is_tensor(x) else torch.from_numpy(np.array(x)).to(dev)

    def run(canvas_wh, bg, objs, obj_wh, obj_known, valid=None):
        total = canvas_wh.shape[0]
        out, boxes, _scales, luma = core(on(batch.local(canvas_wh)), on(bg), on(objs),
                                         on(obj_wh), on(obj_known))
        if spatial:
            # the rank rendered its variants whole: keep its band of rows
            out = band.local(out).contiguous()
        if valid is None:
            s = luma.sum().reshape(1)
            return out, boxes, mesh.all_reduce_sum(s, axes) / total
        w = on(batch.local(valid)).to(torch.float32)
        s = torch.stack([torch.sum(luma * w), torch.sum(w)])
        s = mesh.all_reduce_sum(s, axes)
        return out, boxes, (s[0] / s[1].clamp(min=1.0)).reshape(1)

    if masked:
        def masked_step(canvas_wh, bg, objs, obj_wh, obj_known, valid):
            return run(canvas_wh, bg, objs, obj_wh, obj_known, valid)

        return masked_step

    def step(canvas_wh, bg, objs, obj_wh, obj_known):
        return run(canvas_wh, bg, objs, obj_wh, obj_known)

    return step


def pad_ragged_variants(canvas_wh: np.ndarray, multiple: int):
    """(padded canvas_wh, valid mask): repeat the last variant row up to the
    next multiple of the mesh batch extent, returning the mask that keeps
    padding out of masked stats and lets callers slice the real outputs
    back out. Host numpy, as JAX's."""
    v = canvas_wh.shape[0]
    pad = (-v) % multiple
    valid = np.ones((v + pad,), bool)
    valid[v:] = False
    if pad:
        canvas_wh = np.concatenate(
            [canvas_wh, np.repeat(canvas_wh[-1:], pad, axis=0)]
        )
    return canvas_wh, valid


def background_spec(bg_rgba_u8: torch.Tensor, mode: str = "solid"):
    """(bg tensor for make_fused_render, gradient_horizontal flag), on the
    background's device.

    "solid": uint8 [3] masked-median color. "gradient": uint8 [2, 3] edge
    colors along the lower-variance axis (``ops.background.gradient_spec``,
    the single home of that rule, so the per-request and batched paths
    always agree).
    """
    from ..ops.background import gradient_spec, masked_median_rgb

    if mode == "solid":
        return masked_median_rgb(bg_rgba_u8).to(torch.uint8), True
    if mode != "gradient":
        raise ValueError(f"unknown background mode: {mode!r}")
    c1, c2, horizontal = gradient_spec(bg_rgba_u8)
    return torch.tensor([c1, c2], dtype=torch.uint8, device=bg_rgba_u8.device), horizontal


def fused_multi_ratio_render(
    bundle,
    root: Dict,
    ratios: List[str],
    kernel: str = "pallas",
    background: str = "solid",
    device="cuda",
):
    """Render one bundle's layout at several ratios in a single device pass
    on ``device`` ("cuda" by default; raises without a card).

    Returns ({ratio: np.uint8 [H, W, 4]}, {ratio: boxes int32 [N, 4]}).
    ``kernel="pallas"`` (the default) composes with K2 on a CUDA device
    and with its plain version on the CPU; a K2 failure raises.
    """
    from ..layout.canvas import compute_canvas_size

    dev = resolve_device(str(device))
    sizes = [compute_canvas_size(bundle.background.size, r, verbose=False) for r in ratios]
    w_max = max(w for w, _ in sizes)
    h_max = max(h for _, h in sizes)

    arrays = bundle.to_arrays()
    prog = FlexProgram.from_dsl(root)
    obj_pad = (arrays.objects.shape[1], arrays.objects.shape[2])
    objs, obj_wh, known = map_bundle_to_program(prog, bundle, arrays)

    bg, horizontal = background_spec(
        torch.from_numpy(np.array(bundle.background)).to(dev), background
    )
    step = make_fused_render(
        prog, (h_max, w_max), obj_pad, kernel=kernel, background=background,
        gradient_horizontal=horizontal,
    )
    out, boxes, _scales, _luma = step(
        torch.tensor(sizes, dtype=torch.int32, device=dev),
        bg,
        torch.from_numpy(objs).to(dev),
        torch.from_numpy(obj_wh).to(dev),
        torch.from_numpy(known).to(dev),
    )
    out_np = out.cpu().numpy()
    boxes_np = boxes.cpu().numpy()
    renders = {}
    solved = {}
    for i, r in enumerate(ratios):
        w, h = sizes[i]
        renders[r] = out_np[i, :h, :w]
        solved[r] = boxes_np[i]
    return renders, solved
