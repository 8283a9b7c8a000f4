"""The plain reference of every cell: what the upstream compositor computes,
written from Pillow's and the upstream project's published semantics in
numpy and plain PyTorch. It imports nothing of the program under test and
takes nothing it made.

* ``canvas_size``: the pixel-budget-preserving canvas of the upstream
  ``layout_constraints.compute_canvas_size``.
* ``solid_color`` / ``gradient_canvas``: the upstream
  ``background_resizing.fill_solid`` / ``fill_gradient``.
* ``solve``: the upstream Flex-DSL solver (measure, place, clamp).
* ``resample``: Pillow's ``Image.resize(..., LANCZOS)`` of an RGBA image
  (premultiply, fixed-point horizontal then vertical pass with 22-bit
  coefficients, unpremultiply).
* ``alpha_over``: Pillow's ``Image.alpha_composite`` at a destination.
* ``luma``: mean Rec.709 luminance, in float64.

The controls, which a sound comparison must refuse: ``precision="bf16"``
runs the resample and the alpha-over in bfloat16 instead of Pillow's
integers; ``precision="7bit"`` keeps 7 bits of each 8-bit channel of the
result (the bundles' cutouts have binary alpha, so where no placement is
resized every blend is exact and only the output's bit depth can fall).
"""

from __future__ import annotations

import io
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

PRECISION_BITS = 22  # Pillow's 8-bit-per-channel resample coefficients
REC709 = (0.2126, 0.7152, 0.0722)


# ------------------------------ canvas and background ------------------------------

def canvas_size(original_wh: Tuple[int, int], ratio: str) -> Tuple[int, int]:
    """(W, H) keeping the original pixel count at the ratio "W:H"; half-even rounding."""
    a, b = (float(v) for v in ratio.split(":"))
    px = original_wh[0] * original_wh[1]
    r = a / b
    return max(1, int(round(math.sqrt(px * r)))), max(1, int(round(math.sqrt(px / r))))


def _median_rgb(pixels: np.ndarray) -> Tuple[int, int, int]:
    """np.median of the RGB of alpha > 0 pixels (all pixels when none), truncated."""
    px = pixels.reshape(-1, 4)
    opaque = px[px[:, 3] > 0]
    sel = opaque if len(opaque) else px
    return tuple(int(v) for v in np.median(sel[:, :3], axis=0))


def solid_color(background: np.ndarray) -> Tuple[int, int, int]:
    return _median_rgb(background)


def gradient_spec(background: np.ndarray, strip: int = 8):
    """(c1, c2, horizontal): the 8-px edge-strip medians along the axis of
    lower squared colour distance (ties horizontal)."""
    left, right = _median_rgb(background[:, :strip]), _median_rgb(background[:, -strip:])
    top, bottom = _median_rgb(background[:strip]), _median_rgb(background[-strip:])

    def dist(c1, c2):
        return sum((a - b) ** 2 for a, b in zip(c1, c2))

    if dist(left, right) <= dist(top, bottom):
        return left, right, True
    return top, bottom, False


def background_canvas(background: np.ndarray, wh: Tuple[int, int], mode: str) -> np.ndarray:
    """uint8 [H, W, 4] canvas of the upstream fill_solid / fill_gradient."""
    W, H = wh
    out = np.empty((H, W, 4), np.uint8)
    out[..., 3] = 255
    if mode == "solid":
        out[..., :3] = solid_color(background)
        return out
    if mode != "gradient":
        raise ValueError(f"unknown background {mode!r}")
    c1, c2, horizontal = gradient_spec(background)
    n = W if horizontal else H
    a, b = np.float32(c1), np.float32(c2)
    ramp = np.empty((n, 3), np.uint8)
    for i in range(n):  # the upstream loop: float32 products of a float64 t
        t = i / max(1, n - 1)
        ramp[i] = (np.float32(1 - t) * a + np.float32(t) * b).astype(np.uint8)
    out[..., :3] = ramp[None, :, :] if horizontal else ramp[:, None, :]
    return out


# ------------------------------------ Flex solver ------------------------------------

def _pad4(value) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) of an object's padding_px (int or dict)."""
    if value is None:
        return 0, 0, 0, 0
    if isinstance(value, int):
        return value, value, value, value
    return tuple(int(value.get(k, 0)) for k in ("left", "right", "top", "bottom"))


def _measure(node: Dict, sizes: Dict[int, Tuple[int, int]]) -> Tuple[int, int]:
    if "object_id" in node:
        w, h = sizes.get(int(node["object_id"]), (0, 0))
        l, r, t, b = _pad4(node.get("padding_px"))
        return max(0, w + l + r), max(0, h + t + b)
    kids = node.get("children") or []
    pad = int(node.get("padding_px", 0))
    if not kids:
        return max(0, 2 * pad), max(0, 2 * pad)
    dims = [_measure(k, sizes) for k in kids]
    gaps = int(node.get("gap_px", 0)) * (len(dims) - 1)
    if node.get("direction", "row") == "row":
        w, h = sum(d[0] for d in dims) + gaps, max(d[1] for d in dims)
    else:
        w, h = max(d[0] for d in dims), sum(d[1] for d in dims) + gaps
    return max(0, w + 2 * max(0, pad)), max(0, h + 2 * max(0, pad))


def _start_and_gap(justify, start, extent, sizes, gap):
    n, content = len(sizes), sum(sizes)
    total = content + gap * max(0, n - 1)
    if justify == "center":
        return start + max(0, (extent - total) // 2), gap
    if justify == "end":
        return start + max(0, extent - total), gap
    if justify == "space_between" and n > 1:
        return start, max(0, (extent - content) // (n - 1))
    if justify == "space_around" and n > 0:
        g = max(0, (extent - content) // n)
        return start + g // 2, g
    return start, gap


def _cross(align, start, extent, size):
    if align == "start":
        return start
    if align == "end":
        return start + extent - size
    return start + (extent - size) // 2


def _place_leaf(node, x, y, w, h, sizes, direction, align, out):
    oid = int(node["object_id"])
    l, r, t, b = _pad4(node.get("padding_px"))
    ix1, iy1 = x + l, y + t
    ix2, iy2 = max(ix1, x + w - r), max(iy1, y + h - b)
    iw, ih = ix2 - ix1, iy2 - iy1
    if oid in sizes and sizes[oid][0] > 0 and sizes[oid][1] > 0:
        ow, oh = sizes[oid]
        scale = max(0.0, min([1.0] + ([iw / ow] if iw > 0 else []) + ([ih / oh] if ih > 0 else [])))
        tw, th = int(round(ow * scale)), int(round(oh * scale))
    else:
        tw, th = iw, ih
    tw, th = max(0, min(tw, iw)), max(0, min(th, ih))
    hmode = align if direction == "column" else "start"
    vmode = align if direction == "row" else "start"
    bx = {"center": ix1 + (iw - tw) / 2, "end": ix2 - tw}.get(hmode, ix1)
    by = {"center": iy1 + (ih - th) / 2, "end": iy2 - th}.get(vmode, iy1)
    bx = min(max(bx, ix1), max(ix1, ix2 - tw))
    by = min(max(by, iy1), max(iy1, iy2 - th))
    x1, y1 = int(round(bx)), int(round(by))
    x1 = min(x1, ix2 - tw) if x1 + tw > ix2 else x1
    x1 = max(x1, ix1)
    y1 = min(y1, iy2 - th) if y1 + th > iy2 else y1
    y1 = max(y1, iy1)
    out.append((oid, [x1, y1, x1 + tw, y1 + th]))


def _place(node, x, y, w, h, sizes, out):
    direction = node.get("direction", "row")
    justify, align = node.get("justify", "center"), node.get("align", "center")
    gap, pad = int(node.get("gap_px", 0)), int(node.get("padding_px", 0))
    ix, iy, iw, ih = x + pad, y + pad, max(0, w - 2 * pad), max(0, h - 2 * pad)
    kids = node.get("children") or []
    dims = [_measure(k, sizes) for k in kids]
    row = direction == "row"
    cur, step = _start_and_gap(justify, ix if row else iy, iw if row else ih,
                               [d[0] if row else d[1] for d in dims], gap)
    for kid, (kw, kh) in zip(kids, dims):
        kx, ky = (cur, _cross(align, iy, ih, kh)) if row else (_cross(align, ix, iw, kw), cur)
        if "object_id" in kid:
            _place_leaf(kid, kx, ky, kw, kh, sizes, direction, align, out)
        else:
            _place(kid, kx, ky, kw, kh, sizes, out)
        cur += (kw if row else kh) + step


def solve(root: Dict, wh: Tuple[int, int], sizes: Dict[int, Tuple[int, int]]):
    """[(object_id, [x1, y1, x2, y2])] in paint order, each box shifted into the canvas."""
    placed: List = []
    _place(root, 0, 0, wh[0], wh[1], sizes, placed)
    W, H = wh
    out = []
    for oid, (x1, y1, x2, y2) in placed:
        w, h = x2 - x1, y2 - y1
        x1, y1 = max(0, min(x1, W - w)), max(0, min(y1, H - h))
        out.append((oid, [x1, y1, x1 + w, y1 + h]))
    return out


# ------------------------------------ resample ------------------------------------

def _lanczos(x: np.ndarray) -> np.ndarray:
    def sinc(v):
        safe = np.where(v == 0.0, 1.0, v * np.pi)
        return np.where(v == 0.0, 1.0, np.sin(safe) / safe)

    return np.where((x >= -3.0) & (x < 3.0), sinc(x) * sinc(x / 3.0), 0.0)


def coefficients(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's fixed-point LANCZOS table [out_size, in_size] (int values in float64)."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 3.0 * fscale
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64)
    taps = np.arange(in_size)[None, :]
    inside = (taps >= xmin[:, None]) & (taps < xmax[:, None])
    w = np.where(inside, _lanczos(((taps - center[:, None]) + 0.5) * (1.0 / fscale)), 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    fixed = w * (1 << PRECISION_BITS)
    return np.trunc(np.where(fixed < 0, fixed - 0.5, fixed + 0.5))


def _clip8(acc: torch.Tensor) -> torch.Tensor:
    return torch.floor((acc + (1 << (PRECISION_BITS - 1))) / (1 << PRECISION_BITS)).clamp(0, 255)


def resample(obj: torch.Tensor, wh: Tuple[int, int], precision: str = "exact") -> torch.Tensor:
    """Pillow's LANCZOS resize of uint8 RGBA [h, w, 4] to ``wh``; a copy when
    the size is unchanged."""
    h, w = obj.shape[:2]
    ow, oh = wh
    if (ow, oh) == (w, h):
        return obj.clone()
    dev = obj.device
    x = obj.to(torch.int64)
    a = x[..., 3:]
    tmp = x[..., :3] * a + 128
    pre = torch.cat([((tmp >> 8) + tmp) >> 8, a], dim=-1).to(torch.float64)
    dt = torch.bfloat16 if precision == "bf16" else torch.float64
    if ow != w:
        k = torch.from_numpy(coefficients(w, ow)).to(dev, dt)
        pre = torch.einsum("yxc,ox->yoc", pre.to(dt), k).to(torch.float64)
        pre = _clip8(pre) if precision != "bf16" else (pre / (1 << PRECISION_BITS)).round().clamp(0, 255)
    if oh != h:
        k = torch.from_numpy(coefficients(h, oh)).to(dev, dt)
        pre = torch.einsum("yxc,oy->oxc", pre.to(dt), k).to(torch.float64)
        pre = _clip8(pre) if precision != "bf16" else (pre / (1 << PRECISION_BITS)).round().clamp(0, 255)
    pre = pre.to(torch.int64)
    alpha = pre[..., 3:]
    unpre = torch.where((alpha == 0) | (alpha == 255), pre[..., :3],
                        torch.clamp((255 * pre[..., :3]) // alpha.clamp(min=1), max=255))
    return torch.cat([unpre, alpha], dim=-1).to(torch.uint8)


# ------------------------------------ alpha-over ------------------------------------

def alpha_over(canvas: torch.Tensor, src: torch.Tensor, xy: Tuple[int, int],
               precision: str = "exact") -> None:
    """Pillow's alpha_composite of uint8 RGBA ``src`` onto ``canvas`` at
    ``xy`` (x, y >= 0), cut at the canvas, in place."""
    x, y = xy
    H, W = canvas.shape[:2]
    h, w = min(src.shape[0], H - y), min(src.shape[1], W - x)
    if h <= 0 or w <= 0:
        return
    d = canvas[y:y + h, x:x + w].to(torch.int64)
    s = src[:h, :w].to(torch.int64)
    sa, da = s[..., 3:], d[..., 3:]
    if precision != "bf16":
        blend = da * (255 - sa)
        outa255 = sa * 255 + blend
        coef1 = sa * 255 * 255 * 128 // outa255.clamp(min=1)
        coef2 = 255 * 128 - coef1
        tmp = s[..., :3] * coef1 + d[..., :3] * coef2 + (0x80 << 7)
        rgb = (((tmp >> 8) + tmp) >> 8) >> 7
        t = outa255 + 0x80
        a = ((t >> 8) + t) >> 8
        out = torch.cat([rgb, a], dim=-1)
    else:
        sf, df = s.to(torch.bfloat16), d.to(torch.bfloat16)
        af = sf[..., 3:] / 255
        out_a = af + df[..., 3:] / 255 * (1 - af)
        rgb = (sf[..., :3] * af + df[..., :3] * (df[..., 3:] / 255) * (1 - af)) / out_a.clamp(min=1e-3)
        out = torch.cat([rgb, out_a * 255], dim=-1).round().clamp(0, 255).to(torch.int64)
    canvas[y:y + h, x:x + w] = torch.where(sa == 0, d, out).to(torch.uint8)


def compose(canvas: np.ndarray, objects: Dict[int, np.ndarray], placements: Sequence,
            device, precision: str = "exact") -> torch.Tensor:
    """The upstream compositor: each (object_id, box) in order, resized to
    max(1, box size) and alpha-composited at the box origin. uint8 [H, W, 4]."""
    out = torch.from_numpy(np.array(canvas, np.uint8)).to(device)
    for oid, (x1, y1, x2, y2) in placements:
        if oid not in objects:
            continue
        obj = torch.from_numpy(objects[oid]).to(device)
        alpha_over(out, resample(obj, (max(1, x2 - x1), max(1, y2 - y1)), precision),
                   (x1, y1), precision)
    if precision == "7bit":
        out &= 0xFE
    return out


def luma(rgba: torch.Tensor) -> float:
    """Mean Rec.709 luminance of a uint8 [H, W, 4] image, float64."""
    s = rgba[..., :3].to(torch.float64).sum(dim=(0, 1))
    return float((REC709[0] * s[0] + REC709[1] * s[1] + REC709[2] * s[2]) / max(1, rgba.shape[0] * rgba.shape[1]))


def load_bundle(root) -> Tuple[np.ndarray, Dict[int, np.ndarray]]:
    """(background uint8 [H, W, 4], {object_id: uint8 [h, w, 4]}) of a bundle
    directory (results.json, background.png, the object files), read with PIL."""
    import json
    from pathlib import Path

    from PIL import Image

    root = Path(root)
    items = json.loads((root / "results.json").read_text())
    objects = {}
    for it in items:
        with Image.open(root / it["filename"]) as im:
            objects[int(it["object_id"])] = np.array(im.convert("RGBA"))
    with Image.open(root / "background.png") as im:
        return np.array(im.convert("RGBA")), objects


def decode_png(data: bytes) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"))
