"""The reference background_resizing API on the port.

Counterpart of the root ``background_resizing.py``: the same functions
plus ``device``, with the median and gradient math of ``ops.background``
(exact histogram medians on the device, the reference's float ramp).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from PIL import Image

from ..core.device import resolve_device
from ..ops.background import (
    axis_variance as _axis_variance_impl,
    edge_strip_medians,
    gradient_canvas,
    masked_median_rgb,
    solid_canvas,
)


def _load_background_rgba(background_path: str) -> Image.Image:
    return Image.open(background_path).convert("RGBA")


def _rgba_tensor(img: Image.Image, device: str) -> torch.Tensor:
    return torch.from_numpy(np.array(img.convert("RGBA"))).to(resolve_device(device))


def _median_color_nontransparent(img_rgba: Image.Image,
                                 device: str = "cuda") -> Tuple[int, int, int]:
    """Median RGB over alpha>0 pixels (all pixels if fully transparent)."""
    med = masked_median_rgb(_rgba_tensor(img_rgba, device))
    return tuple(int(x) for x in med.tolist())


def fill_solid(background_path: str, canvas_size: Tuple[int, int],
               device: str = "cuda") -> Image.Image:
    """Solid canvas in the background's median non-transparent color."""
    color = _median_color_nontransparent(_load_background_rgba(background_path), device)
    w, h = canvas_size
    out = solid_canvas(torch.tensor(color, dtype=torch.uint8, device=resolve_device(device)), h, w)
    return Image.fromarray(out.cpu().numpy(), "RGBA")


def _edge_strip_median_colors(img: Image.Image, strip_px: int = 8, device: str = "cuda"):
    strips = edge_strip_medians(_rgba_tensor(img, device), strip_px)
    return tuple(tuple(int(x) for x in s.tolist()) for s in strips)


def _axis_variance(c1: Tuple[int, int, int], c2: Tuple[int, int, int]) -> float:
    return _axis_variance_impl(c1, c2)


def fill_gradient(background_path: str, canvas_size: Tuple[int, int],
                  device: str = "cuda") -> Image.Image:
    """Linear gradient canvas between edge-strip medians; the axis with the
    lower endpoint color variance wins (ties go horizontal)."""
    bg = _load_background_rgba(background_path)
    left, right, top, bottom = _edge_strip_median_colors(bg, device=device)
    horizontal = _axis_variance(left, right) <= _axis_variance(top, bottom)
    c1, c2 = (left, right) if horizontal else (top, bottom)
    w, h = canvas_size
    out = gradient_canvas(np.array(c1, np.uint8), np.array(c2, np.uint8), h, w, horizontal,
                          resolve_device(device))
    return Image.fromarray(out.cpu().numpy(), "RGBA")
