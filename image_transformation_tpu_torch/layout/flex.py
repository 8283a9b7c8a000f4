# Copy of image_transformation_tpu/layout/flex.py (host-only; imports rewritten to this package).
"""The Flex-DSL layout IR and its deterministic host solver.

The Flex-DSL is the pipeline's central abstraction: a depth<=2 tree of
row/column flex containers whose leaves are object references, with
justify/align/gap/padding on containers and per-object tuning (padding,
pin, offset, stick_to). The VLM emits it as JSON; this module solves it
into pixel boxes.

This is the *host oracle*: exact reference semantics (integer floor
division, Python banker's rounding, downscale-only fitting), used by the
orchestrator for single layouts and as the golden oracle for the vectorized
tensor solver (layout/solve.py) that batches under vmap. Layout solving is
O(objects) scalar math — microseconds on host — so keeping the oracle off
the device is the right TPU design; the tensor solver exists for the
batched multi-ratio render path where solving must live inside the jitted
program.

Behavior parity anchors (pinned by golden tests, not copied):
- measurement: reference/macro_placement_test.py:637-686
- placement:   reference/macro_placement_test.py:689-951
- clamping:    reference/macro_placement_test.py:954-964
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

FlexNode = Dict[str, Union[str, int, float, bool, List[Dict]]]

ALLOWED_JUSTIFY = {"start", "center", "end", "space_between", "space_around"}
ALLOWED_ALIGN = {"start", "center", "end"}
ALLOWED_DIRECTION = {"row", "column"}
STICK_TO_EDGES = {"left", "right", "top", "bottom"}


class FlexError(ValueError):
    """Raised for malformed or constraint-violating Flex-DSL input."""


# --------------------------- field sanitizers ---------------------------

def sanitize_padding(value: Union[int, Dict, None], oid: int) -> Dict[str, int]:
    """Normalize padding to a 4-sided dict; raises FlexError on bad input."""
    if value is None:
        return {"left": 0, "right": 0, "top": 0, "bottom": 0}
    if isinstance(value, bool):
        raise FlexError(f"padding_px for object_id {oid} must be int or dict with left/right/top/bottom")
    if isinstance(value, int):
        if value < 0:
            raise FlexError(f"padding_px for object_id {oid} must be non-negative")
        return {"left": value, "right": value, "top": value, "bottom": value}
    if isinstance(value, dict):
        extra = set(value) - {"left", "right", "top", "bottom"}
        if extra:
            raise FlexError(
                f"padding_px for object_id {oid} has unsupported keys: {sorted(extra)}"
            )
        out = {"left": 0, "right": 0, "top": 0, "bottom": 0}
        for key in out:
            raw = value.get(key, 0)
            if not isinstance(raw, int) or isinstance(raw, bool):
                raise FlexError(f"padding_px[{key}] for object_id {oid} must be an integer")
            if raw < 0:
                raise FlexError(f"padding_px[{key}] for object_id {oid} must be non-negative")
            out[key] = raw
        return out
    raise FlexError(
        f"padding_px for object_id {oid} must be int or dict with left/right/top/bottom"
    )


def sanitize_pin(value: Optional[Dict], oid: int) -> Dict[str, str]:
    if value is None:
        return {}
    if not isinstance(value, dict):
        raise FlexError(f"pin for object_id {oid} must be an object with axis keys")
    extra = set(value) - {"horizontal", "vertical"}
    if extra:
        raise FlexError(f"pin for object_id {oid} has unsupported keys: {sorted(extra)}")
    out: Dict[str, str] = {}
    for axis in ("horizontal", "vertical"):
        v = value.get(axis)
        if v is None:
            continue
        if v not in ALLOWED_ALIGN:
            raise FlexError(
                f"pin.{axis} for object_id {oid} must be one of {sorted(ALLOWED_ALIGN)}"
            )
        out[axis] = v
    return out


def sanitize_offset(value: Optional[Dict], oid: int) -> Dict[str, int]:
    if value is None:
        return {"x": 0, "y": 0}
    if not isinstance(value, dict):
        raise FlexError(f"offset_px for object_id {oid} must be an object with x/y")
    extra = set(value) - {"x", "y"}
    if extra:
        raise FlexError(f"offset_px for object_id {oid} has unsupported keys: {sorted(extra)}")
    out: Dict[str, int] = {}
    for axis in ("x", "y"):
        raw = value.get(axis, 0)
        if not isinstance(raw, int) or isinstance(raw, bool):
            raise FlexError(f"offset_px.{axis} for object_id {oid} must be an integer")
        out[axis] = raw
    return out


def sanitize_stick_to(value: Optional[Dict], oid: int) -> Dict[str, Union[List[str], int]]:
    if value is None:
        return {}
    if not isinstance(value, dict):
        raise FlexError(f"stick_to for object_id {oid} must be an object with edges and margin_px")
    extra = set(value) - {"edges", "margin_px"}
    if extra:
        raise FlexError(f"stick_to for object_id {oid} has unsupported keys: {sorted(extra)}")
    edges = value.get("edges")
    if not isinstance(edges, list) or not edges:
        raise FlexError(f"stick_to.edges for object_id {oid} must be a non-empty list")
    normalized: List[str] = []
    for edge in edges:
        if not isinstance(edge, str):
            raise FlexError(f"stick_to.edges entries for object_id {oid} must be strings")
        low = edge.lower()
        if low not in STICK_TO_EDGES:
            raise FlexError(f"stick_to.edge '{edge}' for object_id {oid} is not supported")
        if low in normalized:
            raise FlexError(f"stick_to.edges for object_id {oid} contains duplicate '{low}'")
        normalized.append(low)
    if "left" in normalized and "right" in normalized:
        raise FlexError(f"stick_to.edges for object_id {oid} cannot include both 'left' and 'right'")
    if "top" in normalized and "bottom" in normalized:
        raise FlexError(f"stick_to.edges for object_id {oid} cannot include both 'top' and 'bottom'")
    margin = value.get("margin_px", 0)
    if not isinstance(margin, int) or isinstance(margin, bool):
        raise FlexError(f"stick_to.margin_px for object_id {oid} must be an integer")
    if margin < 0:
        raise FlexError(f"stick_to.margin_px for object_id {oid} must be non-negative")
    return {"edges": normalized, "margin_px": margin}


# ------------------------------- measure -------------------------------

SizeMap = Dict[int, Tuple[int, int]]  # object_id -> (width, height); (0,0) if unknown


def measure_node(node: FlexNode, sizes: SizeMap) -> Tuple[int, int]:
    """Intrinsic (width, height) of an object or container node."""
    if isinstance(node, dict) and "object_id" in node:
        try:
            oid = int(node["object_id"])
        except Exception:
            return 0, 0
        w, h = sizes.get(oid, (0, 0))
        pad = sanitize_padding(node.get("padding_px"), oid)
        return (
            max(0, w + pad["left"] + pad["right"]),
            max(0, h + pad["top"] + pad["bottom"]),
        )

    if not isinstance(node, dict):
        raise FlexError(
            f"layout nodes must be objects, got {type(node).__name__}"
        )
    direction = node.get("direction", "row")
    gap = int(node.get("gap_px", 0))
    pad = int(node.get("padding_px", 0))
    children = node.get("children", []) or []
    if not children:
        return max(0, 2 * pad), max(0, 2 * pad)

    measured = [
        measure_node(ch, sizes) if isinstance(ch, dict) else (0, 0) for ch in children
    ]
    gaps = gap * (len(measured) - 1) if len(measured) > 1 else 0
    if direction == "row":
        total_w = sum(w for w, _ in measured) + gaps
        total_h = max((h for _, h in measured), default=0)
    else:
        total_w = max((w for w, _ in measured), default=0)
        total_h = sum(h for _, h in measured) + gaps
    return (
        int(max(0, total_w + 2 * max(0, pad))),
        int(max(0, total_h + 2 * max(0, pad))),
    )


# -------------------------------- place --------------------------------

def _axis_cursor(justify: str, inner_start: int, inner_extent: int,
                 child_extents: List[int], n: int, gap: int) -> Tuple[int, int]:
    """Starting cursor and inter-child gap for one main axis."""
    content = sum(child_extents)
    total = content + gap * (n - 1 if n > 0 else 0)
    if justify == "start":
        return inner_start, gap
    if justify == "center":
        return inner_start + max(0, (inner_extent - total) // 2), gap
    if justify == "end":
        return inner_start + max(0, inner_extent - total), gap
    if justify == "space_between" and n > 1:
        g = (inner_extent - content) // (n - 1)
        return inner_start, max(0, g)
    if justify == "space_around" and n > 0:
        g = max(0, (inner_extent - content) // n)
        return inner_start + g // 2, g
    return inner_start, gap


def _cross_position(align: str, inner_start: int, inner_extent: int, child_extent: int) -> int:
    if align == "start":
        return inner_start
    if align == "end":
        return inner_start + (inner_extent - child_extent)
    return inner_start + (inner_extent - child_extent) // 2  # center & default


def _place_object(
    obj_node: FlexNode,
    slot_origin: Tuple[int, int],
    slot_size: Tuple[int, int],
    sizes: SizeMap,
    direction: str,
    container_align: str,
    parent_cell: str,
    placements: List[Dict],
) -> None:
    oid = int(obj_node.get("object_id", -1))
    img_w, img_h = sizes.get(oid, (0, 0))
    known = oid in sizes

    padding_raw = obj_node.get("padding_px")
    padding = sanitize_padding(padding_raw, oid)
    pin_raw = obj_node.get("pin")
    pin = sanitize_pin(pin_raw, oid) if pin_raw is not None else {}
    offset_raw = obj_node.get("offset_px")
    offset = sanitize_offset(offset_raw, oid)
    stick_raw = obj_node.get("stick_to")
    stick = sanitize_stick_to(stick_raw, oid) if stick_raw is not None else {}

    sx, sy = slot_origin
    sw, sh = slot_size
    in_x1 = sx + padding["left"]
    in_y1 = sy + padding["top"]
    in_x2 = max(in_x1, sx + sw - padding["right"])
    in_y2 = max(in_y1, sy + sh - padding["bottom"])
    in_w = max(0, in_x2 - in_x1)
    in_h = max(0, in_y2 - in_y1)

    scale = 1.0
    if known and img_w > 0 and img_h > 0:
        candidates = [1.0]
        if in_w > 0:
            candidates.append(in_w / img_w)
        if in_h > 0:
            candidates.append(in_h / img_h)
        scale = max(0.0, min(candidates))
        target_w = int(round(img_w * scale))
        target_h = int(round(img_h * scale))
    else:
        target_w, target_h = in_w, in_h

    target_w = max(0, min(target_w, in_w))
    target_h = max(0, min(target_h, in_h))

    h_mode = pin.get("horizontal") or (container_align if direction == "column" else "start")
    v_mode = pin.get("vertical") or (container_align if direction == "row" else "start")

    rem_w = max(0, in_w - target_w)
    rem_h = max(0, in_h - target_h)

    if h_mode == "center":
        base_x: float = in_x1 + rem_w / 2
    elif h_mode == "end":
        base_x = in_x2 - target_w
    else:
        base_x = in_x1
    if v_mode == "center":
        base_y: float = in_y1 + rem_h / 2
    elif v_mode == "end":
        base_y = in_y2 - target_h
    else:
        base_y = in_y1

    if stick:
        margin = stick.get("margin_px", 0)
        edges = stick.get("edges", [])
        if "left" in edges:
            base_x = in_x1 + margin
        elif "right" in edges:
            base_x = in_x2 - margin - target_w
        if "top" in edges:
            base_y = in_y1 + margin
        elif "bottom" in edges:
            base_y = in_y2 - margin - target_h

    base_x += offset["x"]
    base_y += offset["y"]

    base_x = min(max(base_x, in_x1), max(in_x1, in_x2 - target_w))
    base_y = min(max(base_y, in_y1), max(in_y1, in_y2 - target_h))

    x1 = int(round(base_x))
    y1 = int(round(base_y))
    x2 = x1 + int(target_w)
    y2 = y1 + int(target_h)

    # Shift fully back inside the inner slot (right/bottom first, as in the
    # reference's sequential adjustment).
    if x2 > in_x2:
        x1 -= x2 - in_x2
        x2 = in_x2
    if x1 < in_x1:
        x2 += in_x1 - x1
        x1 = in_x1
    if y2 > in_y2:
        y1 -= y2 - in_y2
        y2 = in_y2
    if y1 < in_y1:
        y2 += in_y1 - y1
        y1 = in_y1

    entry: Dict = {
        "object_id": oid,
        "cell": parent_cell,
        "box": [int(x1), int(y1), int(x2), int(y2)],
        "scale": float(scale),
    }
    if padding_raw is not None:
        entry["padding_px"] = padding
    if pin_raw is not None and pin:
        entry["pin"] = pin
    if offset_raw is not None or offset["x"] or offset["y"]:
        entry["offset_px"] = offset
    if stick_raw is not None and stick:
        entry["stick_to"] = stick
    placements.append(entry)


def place_tree(
    node: FlexNode,
    origin: Tuple[int, int],
    size: Tuple[int, int],
    sizes: SizeMap,
    placements: List[Dict],
    parent_cell: str = "flex_root",
) -> None:
    """Top-down placement of a flex container into ``placements``."""
    x0, y0 = origin
    cw, ch = size
    direction = node.get("direction", "row")
    justify = node.get("justify", "center")
    align = node.get("align", "center")
    gap = int(node.get("gap_px", 0))
    pad = int(node.get("padding_px", 0))

    inner_x = x0 + pad
    inner_y = y0 + pad
    inner_w = max(0, cw - 2 * pad)
    inner_h = max(0, ch - 2 * pad)

    children: List[Dict] = node.get("children", []) or []
    for ch in children:
        if not isinstance(ch, dict):
            raise FlexError(
                f"container children must be objects, got {type(ch).__name__}"
            )
    children = list(children)
    child_sizes = [measure_node(ch, sizes) for ch in children]
    n = len(children)

    if direction == "row":
        cur_x, gap_between = _axis_cursor(
            justify, inner_x, inner_w, [w for w, _ in child_sizes], n, gap
        )
        for idx, ch in enumerate(children):
            w, h = child_sizes[idx]
            py = _cross_position(align, inner_y, inner_h, h)
            if "object_id" in ch:
                _place_object(ch, (cur_x, py), (w, h), sizes, direction, align,
                              parent_cell, placements)
            else:
                place_tree(ch, (cur_x, py), (w, h), sizes, placements, parent_cell)
            cur_x += w + gap_between
    else:
        cur_y, gap_between = _axis_cursor(
            justify, inner_y, inner_h, [h for _, h in child_sizes], n, gap
        )
        for idx, ch in enumerate(children):
            w, h = child_sizes[idx]
            px = _cross_position(align, inner_x, inner_w, w)
            if "object_id" in ch:
                _place_object(ch, (px, cur_y), (w, h), sizes, direction, align,
                              parent_cell, placements)
            else:
                place_tree(ch, (px, cur_y), (w, h), sizes, placements, parent_cell)
            cur_y += h + gap_between


def solve_flex(
    root: FlexNode, canvas_size: Tuple[int, int], sizes: SizeMap,
    parent_cell: str = "flex_root",
) -> List[Dict]:
    """Solve a Flex-DSL root container into clamped pixel placements."""
    placements: List[Dict] = []
    place_tree(root, (0, 0), canvas_size, sizes, placements, parent_cell)
    clamp_boxes(placements, canvas_size)
    return placements


def clamp_boxes(placements: List[Dict], canvas_size: Tuple[int, int]) -> None:
    """Size-preserving shift of each box into the canvas (in place)."""
    tw, th = canvas_size
    for p in placements:
        x1, y1, x2, y2 = p["box"]
        w, h = x2 - x1, y2 - y1
        x1 = max(0, min(x1, tw - w))
        y1 = max(0, min(y1, th - h))
        p["box"] = [int(x1), int(y1), int(x1 + w), int(y1 + h)]
