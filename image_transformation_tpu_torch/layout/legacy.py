# Copy of image_transformation_tpu/layout/legacy.py (host-only).
"""Legacy grid/flow layout helpers (pre-Flex-DSL public surface).

The reference exports these from layout_constraints.py even though the main
pipeline no longer calls them (SURVEY.md §2.6.5); they remain part of the
public API. Parity anchors: the reference layout_constraints.py:144-342
(outputs cross-checked bit-exact in tests/test_cross_legacy.py).

All of this is scalar host logic on object metadata — no device work. The
alignment arithmetic is factored into three axis primitives (`_aligned`,
`_cross_pos`, `_main_start`) shared by the single-object and tiled paths,
and cell bookkeeping goes through a small take-first-free pool.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from PIL import Image

from .canvas import GRID_CELLS, CellName, cell_row_col


@dataclass
class ObjectMeta:
    object_id: int
    label: str
    file: str
    width: int
    height: int


@dataclass
class Placement:
    object_id: int
    cell: CellName
    box: Tuple[int, int, int, int]
    scale: float


def load_object_meta(objects_dir: str, results_json_path: str) -> Dict[int, ObjectMeta]:
    base = Path(results_json_path).parent
    meta: Dict[int, ObjectMeta] = {}
    for it in json.loads(Path(results_json_path).read_text(encoding="utf-8")):
        oid = int(it["object_id"])
        file_abs = str(base / it["filename"])
        with Image.open(file_abs).convert("RGBA") as im:
            w, h = im.size
        meta[oid] = ObjectMeta(oid, it.get("label", ""), file_abs, w, h)
    return meta


# --------------------------------------------------------------------------
# Heuristic 3x3 cell assignment
# --------------------------------------------------------------------------

_FILL_ORDER = (
    "middle_center", "top_center", "bottom_center", "middle_left",
    "middle_right", "top_left", "top_right", "bottom_left", "bottom_right",
)
_BRANDING_CELLS = ("top_right", "bottom_right")


class _CellPool:
    """Hands out the first still-free cell from a candidate list."""

    def __init__(self) -> None:
        self._used: set = set()

    def take(self, candidates: Iterable[CellName]) -> Optional[CellName]:
        for cell in candidates:
            if cell not in self._used:
                self._used.add(cell)
                return cell
        return None


def _objects_by_area(results_json_path: str) -> List[Tuple[int, str]]:
    """(object_id, label) ranked by descending bounding-box area."""
    ranked = []
    for it in json.loads(Path(results_json_path).read_text(encoding="utf-8")):
        x1, y1, x2, y2 = it.get("bounding_box", [0, 0, 0, 0])
        area = max(1, int((x2 - x1) * (y2 - y1)))
        ranked.append((area, int(it["object_id"]), it.get("label", "")))
    ranked.sort(key=lambda t: t[0], reverse=True)
    return [(oid, label) for _, oid, label in ranked]


def baseline_cell_assignments(results_json_path: str) -> List[Tuple[int, CellName]]:
    """Heuristic 3x3 cell assignment: hero to center, logo/text to the right
    column, the rest by descending area."""
    ranked = _objects_by_area(results_json_path)
    if not ranked:
        return []

    pool = _CellPool()
    hero_id = ranked[0][0]
    assignments: List[Tuple[int, CellName]] = [(hero_id, pool.take(["middle_center"]))]
    placed = {hero_id}

    for oid, label in ranked[1:]:
        low = label.lower()
        if "logo" in low or "text" in low:
            cell = pool.take(_BRANDING_CELLS)
            if cell:
                assignments.append((oid, cell))
                placed.add(oid)
    for oid, _ in ranked[1:]:
        if oid in placed:
            continue
        cell = pool.take(_FILL_ORDER)
        if cell:
            assignments.append((oid, cell))
            placed.add(oid)
    return assignments


# --------------------------------------------------------------------------
# Grid-cell finalization (tiling multi-object cells)
# --------------------------------------------------------------------------


def _aligned(key: int, lo: int, hi: int, inner: int, extent: int) -> int:
    """Edge-align along one axis by grid key: 0 -> leading edge, 1 ->
    centered, 2 -> trailing edge."""
    if key == 0:
        return lo
    if key == 1:
        return lo + (inner - extent) // 2
    return hi - extent


def _cross_pos(align: str, key: int, lo: int, hi: int, inner: int, extent: int) -> int:
    """Cross-axis position: 'center' mode always centers; 'edge' mode snaps
    by the cell's grid key."""
    if align == "center":
        return lo + (inner - extent) // 2
    return _aligned(key, lo, hi, inner, extent)


def _main_start(align: str, key: int, lo: int, hi: int, inner: int, total: int) -> int:
    """Tiling cursor start: centered run, or flush to the trailing edge only
    when the cell sits on it (key 2); otherwise the leading edge."""
    if align == "center":
        return lo + (inner - total) // 2
    return hi - total if key == 2 else lo


def _tile_cell(
    objs: List[ObjectMeta],
    bounds: Tuple[int, int, int, int],
    rowcol: Tuple[int, int],
    align: str,
    spacing_px: int,
) -> List[Tuple[int, int, int, int]]:
    """Boxes for objects sharing one cell, tiled along its longer axis."""
    x1, y1, x2, y2 = bounds
    cw, ch = max(1, x2 - x1), max(1, y2 - y1)
    row, col = rowcol
    horizontal = cw >= ch

    if horizontal:
        total = sum(o.width for o in objs) + spacing_px * (len(objs) - 1)
        cursor = _main_start(align, col, x1, x2, cw, total)
    else:
        total = sum(o.height for o in objs) + spacing_px * (len(objs) - 1)
        cursor = _main_start(align, row, y1, y2, ch, total)

    boxes = []
    for o in objs:
        if horizontal:
            py = _cross_pos(align, row, y1, y2, ch, o.height)
            boxes.append((cursor, py, cursor + o.width, py + o.height))
            cursor += o.width + spacing_px
        else:
            px = _cross_pos(align, col, x1, x2, cw, o.width)
            boxes.append((px, cursor, px + o.width, cursor + o.height))
            cursor += o.height + spacing_px
    return boxes


def finalize_layout(
    assignments: List[Tuple[int, CellName]],
    results_json_path: str,
    canvas_size: Tuple[int, int],
    cells: Dict[CellName, Tuple[int, int, int, int]],
    align: str = "center",
    spacing_px: int = 8,
) -> List[Placement]:
    """Place assigned objects in their grid cells (no scaling), tiling
    multi-object cells along the longer cell axis with fixed spacing."""
    meta = load_object_meta(
        str(Path(results_json_path).parent / "objects"), results_json_path
    )
    by_cell: Dict[CellName, List[ObjectMeta]] = {name: [] for name in GRID_CELLS}
    for oid, cell in assignments:
        by_cell.setdefault(cell, [])
        if oid in meta:
            by_cell[cell].append(meta[oid])

    placements: List[Placement] = []
    for cell, objs in by_cell.items():
        if not objs:
            continue
        x1, y1, x2, y2 = cells[cell]
        rowcol = cell_row_col(cell)
        if len(objs) == 1:
            # single occupant: both axes behave as cross axes
            om = objs[0]
            cw, ch = max(1, x2 - x1), max(1, y2 - y1)
            px = _cross_pos(align, rowcol[1], x1, x2, cw, om.width)
            py = _cross_pos(align, rowcol[0], y1, y2, ch, om.height)
            boxes = [(px, py, px + om.width, py + om.height)]
        else:
            boxes = _tile_cell(objs, (x1, y1, x2, y2), rowcol, align, spacing_px)
        placements.extend(
            Placement(o.object_id, cell, box, 1.0) for o, box in zip(objs, boxes)
        )
    return placements


# --------------------------------------------------------------------------
# Flow packing
# --------------------------------------------------------------------------


def pack_flow(
    scaled_objs: List[ObjectMeta],
    canvas_size: Tuple[int, int],
    layout_params: Dict,
    meta: Dict[int, ObjectMeta],
) -> Tuple[List[Placement], Tuple[int, int]]:
    """Centered vertical/horizontal flow packing of pre-scaled objects."""
    align = layout_params.get("align", "center")
    orientation = layout_params.get("orientation", "auto")
    margin_px = layout_params.get("global_margin_px", 20)
    spacing_px = layout_params.get("global_spacing_px", 20)

    tw, th = canvas_size
    if orientation == "auto":
        orientation = "vertical" if th >= tw else "horizontal"
    vertical = orientation == "vertical"

    steps = [(o.height if vertical else o.width) for o in scaled_objs]
    span = th if vertical else tw
    cursor = (span - (sum(steps) + (len(scaled_objs) - 1) * spacing_px)) // 2

    placements: List[Placement] = []
    for o, step in zip(scaled_objs, steps):
        if vertical:
            px = (tw - o.width) // 2 if align == "center" else margin_px
            py = cursor
        else:
            px = cursor
            py = (th - o.height) // 2 if align == "center" else margin_px
        src_w = meta[o.object_id].width
        placements.append(Placement(
            o.object_id,
            f"flow_{orientation}",
            (px, py, px + o.width, py + o.height),
            o.width / src_w if src_w > 0 else 1.0,
        ))
        cursor += step + spacing_px
    return placements, canvas_size


def layout_final_json(
    placements: List[Placement],
    canvas_size: Tuple[int, int],
    margin_pct: float,
    align: str,
) -> Dict:
    return {
        "canvas": {
            "width": canvas_size[0],
            "height": canvas_size[1],
            "margin": margin_pct,
            "align": align,
        },
        "placements": [
            {
                "object_id": p.object_id,
                "cell": p.cell,
                "box": [int(v) for v in p.box],
                "scale": float(p.scale),
            }
            for p in placements
        ],
    }
