"""Labeled contact sheet: exact thumbnails + host text rendering.

Port of image_transformation_tpu/ops/contact_sheet.py. Only the
thumbnail resample is tensor code (ops.resize on the caller's device);
grid pasting and text labels run on the host with PIL, as in the JAX
package.

Geometry parity: thumbnail target sizes replicate PIL's
``Image.thumbnail`` aspect rounding (round-half-to-nearest with
tie-breaking toward the truer aspect). Pixel parity: bit-exact at every
downscale factor — although thumbnail passes reducing_gap=2.0, Pillow's
RGBA premultiply wrapper recurses into resize WITHOUT it (Image.py:
``im = im.resize(size, resample, box)``), so the reduce() pre-pass never
runs for RGBA and thumbnailing IS the plain exact resample. The
Pillow-exact ``reduce()`` arithmetic is still provided
(:func:`_reduce_np`, fixed-point reciprocal rounding) for non-alpha modes
and documentation.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from PIL import Image, ImageDraw, ImageFont


def thumbnail_size(src_wh: Tuple[int, int], max_wh: Tuple[int, int]) -> Tuple[int, int]:
    """PIL Image.thumbnail target-size math (aspect preserved, never up)."""
    w, h = src_wh
    x, y = (math.floor(v) for v in max_wh)
    if w <= x and h <= y:
        return w, h
    aspect = w / h

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect, key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def _premultiply_np(rgba: np.ndarray) -> np.ndarray:
    out = rgba.astype(np.int64)
    a = out[..., 3:4]
    tmp = out[..., :3] * a + 128
    out[..., :3] = ((tmp >> 8) + tmp) >> 8
    return out


def _reduce_np(rgba: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """Pillow Image.reduce, bit-exact: block sums + the fixed-point
    reciprocal rounding ((sum + area/2) * floor(2^24/area)) >> 24."""
    h, w = rgba.shape[:2]
    oh = -(-h // fy)
    ow = -(-w // fx)
    acc = np.add.reduceat(rgba.astype(np.int64), np.arange(0, h, fy), axis=0)
    acc = np.add.reduceat(acc, np.arange(0, w, fx), axis=1)
    cnt_y = np.minimum(np.arange(oh) * fy + fy, h) - np.arange(oh) * fy
    cnt_x = np.minimum(np.arange(ow) * fx + fx, w) - np.arange(ow) * fx
    area = (cnt_y[:, None] * cnt_x[None, :]).astype(np.int64)
    mult = (1 << 24) // area
    out = ((acc + (area // 2)[..., None]) * mult[..., None]) >> 24
    return out.astype(np.uint8)


def thumbnail_exact_u8(
    rgba: np.ndarray, target_wh: Tuple[int, int], *, device: torch.device
) -> np.ndarray:
    """PIL Image.thumbnail pixel parity for RGBA at any factor.

    For RGBA, Pillow's thumbnail is exactly the premultiplied plain
    resample at the aspect-rounded target size (see module docstring), so
    this runs the exact resize on ``device``. Returns uint8 [th, tw, 4]
    on the host.
    """
    from .resize import resize_exact_u8

    h, w = rgba.shape[:2]
    tw, th = thumbnail_size((w, h), target_wh)
    if (tw, th) == (w, h):
        return rgba.copy()
    out = resize_exact_u8(
        torch.from_numpy(np.array(rgba, np.uint8)).to(device),
        (h, w), (th, tw), (max(th, h), max(tw, w)),
    )
    return out[:th, :tw].cpu().numpy()


def _load_font(font_size: int):
    for loader in (
        lambda: ImageFont.truetype("DejaVuSans.ttf", size=font_size),
        lambda: ImageFont.truetype(
            "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf", size=font_size
        ),
        lambda: ImageFont.load_default(),
    ):
        try:
            return loader()
        except Exception:
            continue
    return None


def _measure_text(draw, label: str, font) -> Tuple[int, int]:
    try:
        bbox = draw.textbbox((0, 0), label, font=font)
        return bbox[2] - bbox[0], bbox[3] - bbox[1]
    except Exception:
        return int(len(label) * 7), 12


def build_labeled_contact_sheet(
    objects: Dict[int, Image.Image],
    labels: Dict[int, str],
    thumb_size: Tuple[int, int] = (256, 256),
    cols: int = 4,
    label_height: int = 72,
    font_size: int = 24,
    *,
    device: torch.device,
) -> Image.Image:
    """Grid sheet of labeled thumbnails, ordered by object_id; thumbnails
    are resampled on ``device``."""
    entries = [
        (objects[oid], labels.get(oid, f"id_{oid}")) for oid in sorted(objects)
    ]
    return _build_sheet(entries, thumb_size, cols, label_height, font_size,
                        device=device)


def _build_sheet(
    entries,
    thumb_size: Tuple[int, int] = (256, 256),
    cols: int = 4,
    label_height: int = 72,
    font_size: int = 24,
    *,
    device: torch.device,
) -> Image.Image:
    """One grid cell per (image, label) entry — duplicates preserved, as
    the reference renders one cell per results.json item."""
    if not entries:
        return Image.new(
            "RGBA", (thumb_size[0], thumb_size[1] + label_height), (255, 255, 255, 255)
        )

    rows = (len(entries) + cols - 1) // cols
    cell_w = thumb_size[0]
    cell_h = thumb_size[1] + label_height
    sheet_w, sheet_h = cols * cell_w, rows * cell_h

    # Per-thumbnail exact resample on the device + PIL-exact host paste.
    sheet = Image.new("RGBA", (sheet_w, sheet_h), (255, 255, 255, 255))
    for k, (img, _label) in enumerate(entries):
        thumb = thumbnail_exact_u8(
            np.asarray(img.convert("RGBA")), thumb_size, device=device
        )
        th, tw = thumb.shape[:2]
        r, c = divmod(k, cols)
        x = c * cell_w + (cell_w - tw) // 2
        y = r * cell_h + (thumb_size[1] - th) // 2
        sheet.alpha_composite(Image.fromarray(thumb, "RGBA"), dest=(x, y))

    # Label band: host-side text rasterization.
    draw = ImageDraw.Draw(sheet)
    font = _load_font(font_size)
    for k, (_img, label) in enumerate(entries):
        r, c = divmod(k, cols)
        tw, th_text = _measure_text(draw, label, font)
        tx = c * cell_w + (cell_w - tw) // 2
        ty = r * cell_h + thumb_size[1] + max(0, (label_height - th_text) // 2)
        draw.text((tx, ty), label, fill=(0, 0, 0, 255), font=font)
    return sheet


def build_contact_sheet_from_results(
    results_json_path: str,
    thumb_size: Tuple[int, int] = (256, 256),
    cols: int = 4,
    label_height: int = 72,
    font_size: int = 24,
    *,
    device: torch.device,
) -> Image.Image:
    """Reference-signature convenience: results.json path -> sheet."""
    import json
    from pathlib import Path

    results_json_path = Path(results_json_path)
    with open(results_json_path, "r", encoding="utf-8") as f:
        items = json.load(f)
    # one grid cell PER ITEM, sorted by object_id — duplicate ids keep
    # their own cells, exactly like the reference
    # (reference/macro_placement_test.py:172-196)
    entries = []
    for it in sorted(items, key=lambda it: int(it["object_id"])):
        oid = int(it["object_id"])
        img = Image.open(
            results_json_path.parent / it["filename"]
        ).convert("RGBA")
        entries.append((img, str(it.get("label", f"id_{oid}"))))
    return _build_sheet(entries, thumb_size, cols, label_height, font_size,
                        device=device)
