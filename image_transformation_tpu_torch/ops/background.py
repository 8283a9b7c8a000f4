"""Background synthesis as tensor reductions.

Port of image_transformation_tpu/ops/background.py; equivalents of the
reference background_resizing.py:

- the reference's ``np.median`` over alpha-masked pixels becomes an exact
  256-bin histogram median (index_add + cumulative sum + searchsorted);
- the reference's per-column/per-row Python gradient loops become one
  ramp computed in numpy with the reference loop's float semantics.

Numeric parity notes:
- ``np.median`` of an even-count uint8 sample averages the two middle order
  statistics and the reference then truncates via ``int()`` — reproduced
  here as ``(lo + hi) // 2`` on the two exact order statistics.
- The gradient fill uses ``t = x / max(1, n - 1)`` and truncates
  ``(1-t)*c1 + t*c2`` toward zero, exactly like the reference's
  ``astype(np.uint8)``.

Every function computes on the device of the tensor it is given.
"""

from __future__ import annotations

import numpy as np
import torch


def masked_median_rgb(rgba_u8: torch.Tensor) -> torch.Tensor:
    """Median RGB over alpha>0 pixels (falling back to all pixels).

    rgba_u8: uint8 [H, W, 4]. Returns int64 [3].
    """
    flat = rgba_u8.reshape(-1, 4).to(torch.int64)
    mask = (flat[:, 3] > 0).to(torch.int64)
    if not bool(mask.any()):
        mask = torch.ones_like(mask)
    # one [3*256] histogram (index = c*256 + v)
    chan = torch.arange(3, device=flat.device)[None, :]
    idx = (chan * 256 + flat[:, :3]).reshape(-1)
    counts = (
        torch.zeros(3 * 256, dtype=torch.int64, device=flat.device)
        .index_add_(0, idx, mask[:, None].expand(-1, 3).reshape(-1))
        .reshape(3, 256)
    )
    n = counts[0].sum()
    cdf = torch.cumsum(counts, dim=1)
    k_lo = (n - 1) // 2
    k_hi = n // 2
    lo = torch.searchsorted(cdf, (k_lo + 1).expand(3, 1).contiguous())[:, 0]
    hi = torch.searchsorted(cdf, (k_hi + 1).expand(3, 1).contiguous())[:, 0]
    # np.median averages the two middle samples; int() then truncates.
    return (lo + hi) // 2


def edge_strip_medians(rgba_u8: torch.Tensor, strip_px: int = 8):
    """Median colors of the 8-px left/right/top/bottom strips.

    Returns (left, right, top, bottom) int64 [3] tensors.
    """
    h, w = rgba_u8.shape[:2]
    sl = min(strip_px, w)
    st = min(strip_px, h)
    left = masked_median_rgb(rgba_u8[:, :sl])
    right = masked_median_rgb(rgba_u8[:, max(0, w - strip_px):])
    top = masked_median_rgb(rgba_u8[:st, :])
    bottom = masked_median_rgb(rgba_u8[max(0, h - strip_px):, :])
    return left, right, top, bottom


def axis_variance(c1, c2) -> float:
    """Squared RGB distance used to pick the gradient axis."""
    return float(sum((int(a) - int(b)) ** 2 for a, b in zip(c1, c2)))


def solid_canvas(
    color_rgb: torch.Tensor, height: int, width: int
) -> torch.Tensor:
    """Opaque solid RGBA canvas of the given color, on the color's device.
    Returns uint8 [H, W, 4]."""
    alpha = torch.full((1,), 255, dtype=torch.uint8, device=color_rgb.device)
    rgba = torch.cat([color_rgb.to(torch.uint8), alpha])
    return rgba.expand(height, width, 4).contiguous()


def gradient_canvas(
    c1, c2, height: int, width: int, horizontal: bool, device: torch.device
) -> torch.Tensor:
    """Linear gradient RGBA canvas c1 → c2 along the chosen axis.

    The ramp runs in numpy with the reference loop's exact float
    semantics: t and (1 - t) in f64, cast to f32 at the multiply, separate
    mul/mul/add roundings, truncating uint8 cast. Returns uint8 [H, W, 4]
    on ``device``.
    """
    n = width if horizontal else height
    t64 = np.arange(n) / max(1, n - 1)
    t = t64.astype(np.float32)
    w1 = (1.0 - t64).astype(np.float32)
    c1f = np.asarray(c1).astype(np.float32)
    c2f = np.asarray(c2).astype(np.float32)
    ramp = w1[:, None] * c1f[None, :] + t[:, None] * c2f[None, :]
    ramp_u8 = np.concatenate(
        [ramp.astype(np.uint8), np.full((n, 1), 255, np.uint8)], axis=1
    )
    ramp_t = torch.from_numpy(ramp_u8).to(device)  # truncation, as reference
    if horizontal:
        return ramp_t[None, :, :].expand(height, width, 4).contiguous()
    return ramp_t[:, None, :].expand(height, width, 4).contiguous()


def gradient_spec(bg_rgba_u8: torch.Tensor):
    """(c1, c2, horizontal): endpoint colors + axis for the gradient fill.

    The reference's axis-selection rule: edge-strip medians compared by
    squared RGB distance, lower-variance axis wins (ties go horizontal).
    """
    left, right, top, bottom = (
        tuple(int(x) for x in c.tolist()) for c in edge_strip_medians(bg_rgba_u8)
    )
    horizontal = axis_variance(left, right) <= axis_variance(top, bottom)
    c1, c2 = (left, right) if horizontal else (top, bottom)
    return c1, c2, horizontal


def synthesize_canvas(bg_rgba_u8: torch.Tensor, width: int, height: int,
                      mode: str = "solid") -> torch.Tensor:
    """Canvas synthesis entry point: "solid" = median non-transparent color
    (the reference's only mode); "gradient" = edge-strip medians along the
    lower-variance axis (the reference's fill_gradient semantics). Returns
    uint8 [H, W, 4] on the background's device."""
    if mode == "gradient":
        c1, c2, horizontal = gradient_spec(bg_rgba_u8)
        return gradient_canvas(
            np.array(c1, np.uint8), np.array(c2, np.uint8),
            height, width, horizontal, bg_rgba_u8.device,
        )
    if mode != "solid":
        raise ValueError(f"unknown background mode: {mode!r}")
    return solid_canvas(masked_median_rgb(bg_rgba_u8), height, width)
