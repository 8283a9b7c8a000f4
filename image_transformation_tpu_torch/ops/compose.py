"""Resize + alpha-over composition on torch tensors (plain versions).

Port of image_transformation_tpu/ops/compose.py, exact path. Per
placement, LANCZOS-resize the RGBA cutout to its box (ops.resize, Pillow
tables) and alpha-over it onto the canvas, honoring list order (z-order).
Alpha-over replicates Pillow's fixed-point arithmetic (AlphaComposite.c,
PRECISION_BITS=7) in int32, so compositing is bit-exact vs PIL.

The host-table composes (:func:`composite_exact`,
:func:`composite_canvas_tables_indexed`) go through K1's wrapper
(``ops/compose_kernels.fused_compose``): the kernel for a CUDA canvas, its
plain version, built from the functions here, for a CPU canvas.
:func:`composite_canvas` / :func:`composite_batch` are the JAX package's
XLA-path composite, with tables from the traced f32 table code, in plain
PyTorch.

Unlike the JAX package, :func:`_blend_window` writes into the canvas it is
given (saving a full-canvas copy per placement); the public ``composite_*``
functions clone their input canvas first and never modify it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .resize import build_coeffs_traced, resize_with_tables

_PRECISION_BITS = 7


def _shift_for_div255(a: torch.Tensor) -> torch.Tensor:
    # Pillow's SHIFTFORDIV255: ((a >> 8) + a) >> 8  ==  a // 255 (rounded via caller bias)
    return ((a >> 8) + a) >> 8


def alpha_over_u8(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Pillow-exact alpha compositing of uint8 RGBA tensors [..., 4].

    Returns int32 [..., 4] with uint8 values. src alpha 0 passes dst through
    exactly (including RGB), as in Pillow.
    """
    dst = dst.to(torch.int32)
    src = src.to(torch.int32)
    sa = src[..., 3]
    da = dst[..., 3]
    blend = da * (255 - sa)
    outa255 = sa * 255 + blend
    safe = torch.where(outa255 == 0, torch.ones_like(outa255), outa255)
    coef1 = torch.div(
        sa * (255 * 255 * (1 << _PRECISION_BITS)), safe, rounding_mode="floor"
    )
    coef2 = (255 << _PRECISION_BITS) - coef1
    tmp = src[..., :3] * coef1[..., None] + dst[..., :3] * coef2[..., None]
    out_rgb = _shift_for_div255(tmp + (0x80 << _PRECISION_BITS)) >> _PRECISION_BITS
    out_a = _shift_for_div255(outa255 + 0x80)
    out = torch.cat([out_rgb, out_a[..., None]], dim=-1)
    return torch.where((sa == 0)[..., None], dst, out)


def _blend_window(
    canvas_u8: torch.Tensor, resized: torch.Tensor, x1: int, y1: int
) -> torch.Tensor:
    """Alpha-over ``resized`` [mh, mw, 4] at (x1, y1) onto ``canvas_u8``
    [H, W, 4] IN PLACE, cropped to the canvas; returns the canvas.

    A NEGATIVE or off-canvas origin (x1 < 0, y1 < 0, x1 >= W or y1 >= H)
    drops the placement, as the JAX kernel does (PARITY.md #4: PIL raises
    on a negative dest; solver boxes are always non-negative).
    """
    h_c, w_c = canvas_u8.shape[0], canvas_u8.shape[1]
    x1, y1 = int(x1), int(y1)
    if x1 < 0 or y1 < 0 or x1 >= w_c or y1 >= h_c:
        return canvas_u8
    hh = min(resized.shape[0], h_c - y1)
    ww = min(resized.shape[1], w_c - x1)
    window = canvas_u8[y1:y1 + hh, x1:x1 + ww]
    window.copy_(alpha_over_u8(window, resized[:hh, :ww]).to(torch.uint8))
    return canvas_u8


def paste_object(
    canvas: torch.Tensor, obj: torch.Tensor, xy, wh=None
) -> torch.Tensor:
    """Single windowed alpha-over paste onto a copy of a uint8 canvas.

    obj: [mh, mw, 4] holding uint8 values, zero outside its live region
    (zero alpha => exact dst passthrough, as in Pillow).
    """
    del wh  # the zero-alpha region of obj already masks the live box
    return _blend_window(canvas.to(torch.uint8).clone(), obj, xy[0], xy[1])


def composite_canvas_tables_indexed(
    canvas_u8: torch.Tensor,
    objs_all: torch.Tensor,
    perm,
    boxes,
    kh_i32: torch.Tensor,
    kv_i32: torch.Tensor,
    same_size,
) -> torch.Tensor:
    """Compose placements that index into a fixed object tensor:
    ``perm[k]`` selects the source cutout of placement k.

    canvas_u8 [H, W, 4] u8; objs_all [No, Hm, Wm, 4] u8; perm [N];
    boxes [N, 4] (x1, y1, x2, y2); kh_i32 [N, Wout_max, Wm];
    kv_i32 [N, Hout_max, Hm]; same_size [N] (Pillow identity shortcut).
    Returns a new uint8 [H, W, 4] tensor; the input canvas is not modified.
    Runs K1 (B=1) on a CUDA canvas, its plain version on a CPU canvas.
    """
    # compose_kernels builds on this module, so it is imported late
    from .compose_kernels import FLAG_IDENTITY, FLAG_LIVE, fused_compose

    dev = canvas_u8.device
    work = canvas_u8.to(torch.uint8).clone(memory_format=torch.contiguous_format)
    perm = torch.as_tensor(perm, dtype=torch.long, device=objs_all.device)
    flags = [FLAG_LIVE | (FLAG_IDENTITY if bool(s) else 0) for s in same_size]
    fused_compose(
        work[None], objs_all.to(torch.uint8)[perm][None].to(dev).contiguous(),
        kh_i32.to(dev, torch.int32).contiguous()[None],
        kv_i32.to(dev, torch.int32).contiguous()[None],
        torch.as_tensor(np.asarray(boxes.cpu() if torch.is_tensor(boxes) else boxes),
                        dtype=torch.int32, device=dev).reshape(1, -1, 4),
        torch.tensor([flags], dtype=torch.uint8, device=dev).reshape(1, -1),
    )
    return work


def composite_canvas_tables_indexed_many(
    canvas_u8: torch.Tensor,
    objs_all: torch.Tensor,
    perm,
    boxes,
    kh_i32: torch.Tensor,
    kv_i32: torch.Tensor,
    same_size,
) -> torch.Tensor:
    """A batch of independent placement sets (leading dim B) composed onto
    one shared canvas and object tensor in ONE K1 call over B canvases
    (port of ops/compose.py:255; the serving coalescer's merge).

    canvas_u8 [H, W, 4]; objs_all [No, Hm, Wm, 4]; perm [B, N]; boxes
    [B, N, 4]; kh_i32 [B, N, Wout_max, Wm]; kv_i32 [B, N, Hout_max, Hm];
    same_size [B, N]. A row whose tables are all zero is padding (JAX's
    exact no-op) and is not launched. Returns a new uint8 [B, H, W, 4] on
    the canvas's device: K1 on a CUDA canvas, its plain version on a CPU
    canvas."""
    from .compose_kernels import FLAG_IDENTITY, FLAG_LIVE, fused_compose

    dev = canvas_u8.device
    kh = torch.as_tensor(kh_i32).to(dev, torch.int32).contiguous()
    kv = torch.as_tensor(kv_i32).to(dev, torch.int32).contiguous()
    perm = torch.as_tensor(perm).to(dev, torch.long)
    live = kh.flatten(2).ne(0).any(-1)
    same = torch.as_tensor(same_size).to(dev, torch.bool)
    flags = (live.to(torch.uint8) * FLAG_LIVE) | (same.to(torch.uint8) * FLAG_IDENTITY)
    out = canvas_u8.to(torch.uint8)[None].repeat(perm.shape[0], 1, 1, 1)
    fused_compose(
        out, objs_all.to(dev, torch.uint8)[perm].contiguous(), kh, kv,
        torch.as_tensor(boxes).to(dev, torch.int32).contiguous(), flags.contiguous(),
    )
    return out


def _grow_canvas(canvas_u8: torch.Tensor, out_max_hw: Tuple[int, int]) -> torch.Tensor:
    """A uint8 copy of the canvas, zero-padded at the bottom/right so every
    blend window fits (only when the object envelope exceeds the canvas);
    the caller crops the fringe away, dropping pixels that land there."""
    h_c, w_c = canvas_u8.shape[:2]
    grow_h = max(0, out_max_hw[0] - h_c)
    grow_w = max(0, out_max_hw[1] - w_c)
    work = canvas_u8.to(torch.uint8).clone()
    if grow_h or grow_w:
        work = torch.nn.functional.pad(work, (0, 0, 0, grow_w, 0, grow_h))
    return work


def composite_canvas(
    canvas_u8: torch.Tensor,
    objs_u8: torch.Tensor,
    obj_hw,
    boxes,
    out_max_hw: Tuple[int, int] | None = None,
) -> torch.Tensor:
    """Compose all objects onto the canvas in list order, with coefficient
    traced f32 tables (port of ops/compose.py:143-184).

    canvas_u8 [H, W, 4]; objs_u8 [N, Hm, Wm, 4] zero padded; obj_hw [N, 2]
    (h, w); boxes [N, 4] (x1, y1, x2, y2). Box sizes floor at 1 px; a
    negative or off-canvas origin drops the placement. The resample is the
    exact fixed-point one (``resample_fixed``), so this equals the JAX
    function under the tests' ``exact_traced_resample`` pin up to the
    tables' own ±1-unit envelope. Returns a new uint8 [H, W, 4] canvas.
    """
    h_c, w_c = canvas_u8.shape[:2]
    if out_max_hw is None:
        out_max_hw = (h_c, w_c)
    dev = canvas_u8.device
    hw = torch.as_tensor(obj_hw, device=dev).to(torch.int64).reshape(-1, 2)
    bx = torch.as_tensor(boxes, device=dev).to(torch.int64).reshape(-1, 4)
    out_w = torch.clamp(bx[:, 2] - bx[:, 0], min=1)
    out_h = torch.clamp(bx[:, 3] - bx[:, 1], min=1)
    kh = build_coeffs_traced(hw[:, 1], out_w, objs_u8.shape[2], out_max_hw[1])
    kv = build_coeffs_traced(hw[:, 0], out_h, objs_u8.shape[1], out_max_hw[0])
    same = ((out_h == hw[:, 0]) & (out_w == hw[:, 1])).tolist()
    origins = bx[:, :2].tolist()
    work = _grow_canvas(canvas_u8, out_max_hw)
    for k in range(objs_u8.shape[0]):
        resized = resize_with_tables(objs_u8[k].to(dev), kh[k], kv[k], same[k])
        _blend_window(work, resized, origins[k][0], origins[k][1])
    return work[:h_c, :w_c].contiguous()


def composite_batch(canvases, objs, obj_hw, boxes,
                    out_max_hw: Tuple[int, int] | None = None) -> torch.Tensor:
    """:func:`composite_canvas` over a batch: canvases [B, H, W, 4], objects
    [B, N, Hm, Wm, 4], sizes [B, N, 2], boxes [B, N, 4] -> [B, H, W, 4]."""
    return torch.stack([
        composite_canvas(canvases[b], objs[b], obj_hw[b], boxes[b], out_max_hw)
        for b in range(canvases.shape[0])
    ])


def composite_canvas_tables(
    canvas_u8: torch.Tensor,
    objs_u8: torch.Tensor,
    boxes,
    kh_i32,
    kv_i32,
    same_size,
    wide: bool = False,
) -> torch.Tensor:
    """Compose with precomputed per-object coefficient tables (port of
    ops/compose.py:193-219), in list order.

    canvas_u8 [H, W, 4]; objs_u8 [N, Hm, Wm, 4]; boxes [N, 4]; kh_i32
    [N, Wout_max, Wm]; kv_i32 [N, Hout_max, Hm]; same_size [N] (Pillow's
    identity shortcut). With host-built tables the output is bit-exact vs
    PIL. ``wide`` selects the TPU's chunked accumulation and is ignored: the
    float64 resample is exact at any tap count. Returns a new uint8
    [H, W, 4] canvas on the canvas's device."""
    del wide
    h_c, w_c = canvas_u8.shape[:2]
    dev = canvas_u8.device
    kh = torch.as_tensor(kh_i32, device=dev)
    kv = torch.as_tensor(kv_i32, device=dev)
    origins = torch.as_tensor(boxes).reshape(-1, 4)[:, :2].tolist()
    same = torch.as_tensor(same_size).reshape(-1).tolist()
    work = _grow_canvas(canvas_u8, (kv.shape[1], kh.shape[1]))
    for k in range(objs_u8.shape[0]):
        resized = resize_with_tables(objs_u8[k].to(dev), kh[k], kv[k], bool(same[k]))
        _blend_window(work, resized, origins[k][0], origins[k][1])
    return work[:h_c, :w_c].contiguous()


def composite_exact(
    canvas_u8: torch.Tensor,
    objs_u8: torch.Tensor,
    obj_hw,
    boxes,
    out_max_hw: Tuple[int, int] | None = None,
) -> torch.Tensor:
    """Host-driven exact compose: boxes/sizes are concrete, coefficient
    tables are built bit-exactly on the host and moved to the canvas's
    device. objs_u8 [N, Hm, Wm, 4]; obj_hw [N, 2] (h, w); boxes [N, 4].
    Unlike the engine, boxes may upscale: ``out_max_hw`` defaults to the
    larger of the pad envelope and the largest box. Runs K1 on a CUDA
    canvas, its plain version on a CPU canvas. Returns a new canvas."""
    from .compose_kernels import fused_compose, fused_tables_prep

    n, pad_h, pad_w = objs_u8.shape[0], objs_u8.shape[1], objs_u8.shape[2]
    if out_max_hw is None:
        need_h = max((max(1, int(b[3]) - int(b[1])) for b in boxes), default=1)
        need_w = max((max(1, int(b[2]) - int(b[0])) for b in boxes), default=1)
        out_max_hw = (max(need_h, pad_h), max(need_w, pad_w))
    boxes = np.asarray(boxes, np.int64).reshape(1, n, 4)
    tables = fused_tables_prep(
        np.asarray(obj_hw, np.int64).reshape(1, n, 2), boxes,
        (canvas_u8.shape[0], canvas_u8.shape[1]), (pad_h, pad_w), out_max_hw,
    )
    dev = canvas_u8.device
    work = canvas_u8.to(torch.uint8).clone(memory_format=torch.contiguous_format)
    fused_compose(
        work[None], objs_u8.to(dev, torch.uint8).contiguous()[None],
        *(torch.from_numpy(a).to(dev) for a in tables),
    )
    return work
