# Copy of image_transformation_tpu/layout/canvas.py (host-only; imports rewritten to this package).
"""Canvas sizing and the 3x3 grid partition.

Behavioral parity with the reference layout_constraints.py
(reference/layout_constraints.py:44-114) and the aspect-family
classifier (reference/macro_placement_test.py:999-1012):

- ``compute_canvas_size`` preserves the original pixel budget at the target
  aspect ratio: W = sqrt(px * r), H = sqrt(px / r), rounded half-even
  (Python ``round``) and floored at 1.
- ``grid_cells`` carves the margin-inset canvas into a 3x3 grid using floor
  division for the cell extents.

These are scalar host-side computations by design: canvas dimensions must be
*static* for XLA (they pick the compiled shape of every downstream kernel),
so they are resolved on host before any traced computation. A fixed "ratio
menu" therefore maps to a small set of static shapes that XLA compiles once.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

CellName = str

GRID_CELLS: List[CellName] = [
    "top_left", "top_center", "top_right",
    "middle_left", "middle_center", "middle_right",
    "bottom_left", "bottom_center", "bottom_right",
]


def parse_ratio(ratio: str) -> float:
    """Parse ``"W:H"`` into the scalar W/H. Raises ValueError on bad input."""
    parts = ratio.split(":")
    if len(parts) != 2:
        raise ValueError(f"Invalid ratio '{ratio}', expected W:H")
    w, h = float(parts[0]), float(parts[1])
    if w <= 0 or h <= 0:
        raise ValueError("Ratio components must be positive")
    return w / h


def compute_canvas_size(
    original_size: Tuple[int, int], ratio: str, verbose: bool = True
) -> Tuple[int, int]:
    """Pixel-budget-preserving canvas size at the target aspect ratio.

    W*H ~= original pixel count and W/H ~= parse_ratio(ratio); both hold
    within 2% (pinned by tests). Rounding uses Python's banker's rounding to
    match the reference exactly.
    """
    ow, oh = original_size
    px = ow * oh
    r = parse_ratio(ratio)
    tw = max(1, int(round(math.sqrt(px * r))))
    th = max(1, int(round(math.sqrt(px / r))))
    if verbose:
        print(
            f"Canvas sizing: {ow}x{oh} ({px:,} px) → {tw}x{th} "
            f"({tw * th:,} px, ratio {tw / th:.3f})"
        )
    return tw, th


def grid_cells(
    canvas_size: Tuple[int, int], margin_pct: float
) -> Dict[CellName, Tuple[int, int, int, int]]:
    """3x3 grid of (x1, y1, x2, y2) cells inside the margin-inset canvas."""
    tw, th = canvas_size
    mx = int(round(tw * margin_pct))
    my = int(round(th * margin_pct))
    col_w = (tw - 2 * mx) // 3
    row_h = (th - 2 * my) // 3
    rects: Dict[CellName, Tuple[int, int, int, int]] = {}
    for idx, name in enumerate(GRID_CELLS):
        cy, cx = divmod(idx, 3)
        sx = mx + cx * col_w
        sy = my + cy * row_h
        rects[name] = (sx, sy, sx + col_w, sy + row_h)
    return rects


def cell_row_col(cell: CellName) -> Tuple[int, int]:
    idx = GRID_CELLS.index(cell)
    return idx // 3, idx % 3


def ratio_family(ratio: str) -> str:
    """Classify a ratio into vertical / square / horizontal / u-wide.

    Thresholds match the reference: H/W > 2.2 => vertical; W/H > 3.2 =>
    u-wide; W/H > 2.2 => horizontal; otherwise square.
    """
    try:
        w_s, h_s = ratio.split(":")
        w, h = float(w_s), float(h_s)
        r = w / max(1e-6, h)
        if (h / max(1e-6, w)) > 2.2:
            return "vertical"
        if r > 3.2:
            return "u-wide"
        if r > 2.2:
            return "horizontal"
        return "square"
    except Exception:
        return "unknown"
