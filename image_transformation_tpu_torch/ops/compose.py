"""Resize + alpha-over composition on torch tensors (plain versions).

Port of image_transformation_tpu/ops/compose.py, exact path. Per
placement, LANCZOS-resize the RGBA cutout to its box (ops.resize, Pillow
tables) and alpha-over it onto the canvas, honoring list order (z-order).
Alpha-over replicates Pillow's fixed-point arithmetic (AlphaComposite.c,
PRECISION_BITS=7) in int32, so compositing is bit-exact vs PIL.

These are the plain PyTorch versions: the engine's compose on a CUDA
device goes through the hand-written kernel in ops/compose_kernels.py,
whose CPU path is built from the functions here.

Unlike the JAX package, :func:`_blend_window` writes into the canvas it is
given (saving a full-canvas copy per placement); the public ``composite_*``
functions clone their input canvas first and never modify it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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
    Runs K1's plain version (B=1) on the canvas's device.
    """
    # compose_kernels builds on this module, so it is imported late
    from .compose_kernels import FLAG_IDENTITY, FLAG_LIVE, fused_compose_reference

    dev = canvas_u8.device
    work = canvas_u8.to(torch.uint8).clone()
    perm = torch.as_tensor(perm, dtype=torch.long, device=objs_all.device)
    flags = [FLAG_LIVE | (FLAG_IDENTITY if bool(s) else 0) for s in same_size]
    fused_compose_reference(
        work[None], objs_all.to(torch.uint8)[perm][None].to(dev),
        kh_i32.to(dev, torch.int32).contiguous()[None],
        kv_i32.to(dev, torch.int32).contiguous()[None],
        torch.as_tensor(np.asarray(boxes.cpu() if torch.is_tensor(boxes) else boxes),
                        dtype=torch.int32, device=dev).reshape(1, -1, 4),
        torch.tensor([flags], dtype=torch.uint8, device=dev).reshape(1, -1),
    )
    return work


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
    larger of the pad envelope and the largest box. Returns a new canvas."""
    from .compose_kernels import fused_compose_reference, fused_tables_prep

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
    work = canvas_u8.to(torch.uint8).clone()
    fused_compose_reference(
        work[None], objs_u8.to(dev, torch.uint8).contiguous()[None],
        *(torch.from_numpy(a).to(dev) for a in tables),
    )
    return work
