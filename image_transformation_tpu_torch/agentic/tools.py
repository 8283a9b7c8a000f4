# Copy of image_transformation_tpu/agentic/tools.py (host-only).
"""Agent tools: the macro set_flex_json solver and micro pixel nudges.

Parity anchors:
- simplified top-left flex solver (no justify/align; cursor packing from
  the origin; canvas-overflow and coverage errors):
  the reference's agentic/utils/layout.py:23-121
- set_flex_json structural sanitizer (type=flex, direction, non-empty
  children; strips everything else):
  the reference's agentic/tools/macro_layouter/placements.py:11-59
- adjust_x/adjust_y with id-or-case-insensitive-name resolution:
  the reference's agentic/tools/micro_layouter/positioning.py
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .state import AgentState, ObjectMeta, PlacementState


# ------------------------- simplified flex solver -------------------------

def _require_non_negative(value: int, label: str) -> int:
    if value < 0:
        raise ValueError(f"{label} cannot be negative")
    return value


def measure_simple(node: Dict, objects: Dict[int, ObjectMeta]) -> Tuple[int, int]:
    """Intrinsic (w, h): objects at natural size; containers stack children
    along ``direction`` with gap and symmetric padding. Unbounded depth."""
    if "object_id" in node:
        meta = objects[int(node["object_id"])]
        return meta.width, meta.height
    direction = node.get("direction")
    if direction not in {"row", "column"}:
        raise ValueError("direction must be 'row' or 'column'")
    children = node.get("children", [])
    if not children:
        raise ValueError("container must have at least one child")
    gap = _require_non_negative(int(node.get("gap_px", 0)), "gap_px")
    pad = _require_non_negative(int(node.get("padding_px", 0)), "padding_px")
    sizes = [measure_simple(ch, objects) for ch in children]
    if direction == "row":
        w = sum(s[0] for s in sizes) + gap * (len(sizes) - 1)
        h = max(s[1] for s in sizes)
    else:
        w = max(s[0] for s in sizes)
        h = sum(s[1] for s in sizes) + gap * (len(sizes) - 1)
    return w + 2 * pad, h + 2 * pad


def _place_simple(
    node: Dict,
    origin: Tuple[int, int],
    objects: Dict[int, ObjectMeta],
    placements: Dict[int, PlacementState],
) -> Tuple[int, int]:
    if "object_id" in node:
        oid = int(node["object_id"])
        meta = objects[oid]
        placements[oid] = PlacementState(
            object_id=oid, name=meta.name, x=origin[0], y=origin[1],
            width=meta.width, height=meta.height,
        )
        return meta.width, meta.height

    direction = node.get("direction")
    gap = _require_non_negative(int(node.get("gap_px", 0)), "gap_px")
    pad = _require_non_negative(int(node.get("padding_px", 0)), "padding_px")
    children = node.get("children", [])
    if not children:
        raise ValueError("container must have at least one child")
    cx, cy = origin[0] + pad, origin[1] + pad
    sizes: List[Tuple[int, int]] = []
    for ch in children:
        size = _place_simple(ch, (cx, cy), objects, placements)
        sizes.append(size)
        if direction == "row":
            cx += size[0] + gap
        else:
            cy += size[1] + gap
    if direction == "row":
        w = sum(s[0] for s in sizes) + gap * (len(sizes) - 1)
        h = max(s[1] for s in sizes)
    else:
        w = max(s[0] for s in sizes)
        h = sum(s[1] for s in sizes) + gap * (len(sizes) - 1)
    return w + 2 * pad, h + 2 * pad


def placements_from_flex(
    flex: Dict, canvas_size: Tuple[int, int], objects: Dict[int, ObjectMeta]
) -> Dict[int, PlacementState]:
    """Solve the simplified DSL; raises on canvas overflow or missing ids."""
    if "root" not in flex:
        raise ValueError("Flex JSON must include 'root'")
    placements: Dict[int, PlacementState] = {}
    total = _place_simple(flex["root"], (0, 0), objects, placements)
    if total[0] > canvas_size[0] or total[1] > canvas_size[1]:
        raise ValueError(
            "Flex DSL produces placements larger than canvas; revise macro layout"
        )
    missing = set(objects) - set(placements)
    if missing:
        raise ValueError(f"Placement missing required object ids: {sorted(missing)}")
    return placements


def _sanitize_container(node: Dict, objects: Dict[int, ObjectMeta]) -> Dict:
    """Keep only the structural fields the simplified solver understands."""
    if not isinstance(node, dict):
        raise ValueError("flex node must be an object")
    if "object_id" in node:
        oid = int(node["object_id"])
        if oid not in objects:
            raise ValueError(f"unknown object_id {oid}")
        return {"object_id": oid, "name": objects[oid].name}
    if node.get("type", "flex") != "flex":
        raise ValueError("only type=flex containers are supported")
    direction = node.get("direction")
    if direction not in {"row", "column"}:
        raise ValueError("direction must be 'row' or 'column'")
    children = node.get("children", [])
    if not isinstance(children, list) or not children:
        raise ValueError("container must have non-empty children")
    out = {"type": "flex", "direction": direction}
    for key in ("gap_px", "padding_px"):
        if key in node:
            out[key] = _require_non_negative(int(node[key]), key)
    out["children"] = [_sanitize_container(ch, objects) for ch in children]
    return out


def set_flex_json(state: AgentState, root: Dict, raw_text: str = "") -> Dict:
    """Macro tool: sanitize the structure, solve it, install placements."""
    clean = _sanitize_container(root, state.objects)
    state.flex_json = {"root": clean}
    state.flex_text = raw_text
    state.placements = placements_from_flex(
        state.flex_json, state.canvas_size, state.objects
    )
    return {"placed": sorted(state.placements)}


MACRO_TOOL_REGISTRY = {"set_flex_json": set_flex_json}


# ------------------------------ micro tools ------------------------------

def _resolve_object(state: AgentState, object_identifier: str) -> PlacementState:
    """Resolve by numeric id or case-insensitive name."""
    ident = str(object_identifier).strip()
    if ident.isdigit():
        placement = state.placements.get(int(ident))
        if placement is None:
            raise ValueError(f"Object id {ident} has no placement yet")
        return placement
    low = ident.lower()
    for placement in state.placements.values():
        if placement.name.strip().lower() == low:
            return placement
    raise ValueError(f"No placement matches object '{object_identifier}'")


def _clamp_origin(state: AgentState, placement) -> None:
    """Keep the nudged box on-canvas. Without this, a critic-suggested
    nudge past an edge goes negative and the compose kernel's documented
    negative-origin no-op (PARITY #4) silently DROPS the object from the
    render while layout_json still records it — the critic only ever sees
    coordinates, so nothing would catch the vanished object."""
    cw, ch = state.canvas_size
    placement.x = max(0, min(placement.x, max(0, cw - placement.width)))
    placement.y = max(0, min(placement.y, max(0, ch - placement.height)))


def adjust_x(state: AgentState, object: str, pixels: int) -> Dict:
    """Move an object horizontally (positive=right); clamped on-canvas."""
    placement = _resolve_object(state, object)
    placement.move_dx(int(pixels))
    _clamp_origin(state, placement)
    return {"object_id": placement.object_id, "x": placement.x, "y": placement.y}


def adjust_y(state: AgentState, object: str, pixels: int) -> Dict:
    """Move an object vertically (positive=down); clamped on-canvas."""
    placement = _resolve_object(state, object)
    placement.move_dy(int(pixels))
    _clamp_origin(state, placement)
    return {"object_id": placement.object_id, "x": placement.x, "y": placement.y}


MICRO_TOOL_REGISTRY = {"adjust_x": adjust_x, "adjust_y": adjust_y}

MICRO_TOOL_DEFINITIONS = [
    {
        "type": "function",
        "function": {
            "name": name,
            "description": (
                f"Move an object {'horizontally' if axis == 'x' else 'vertically'} "
                f"by a number of pixels (positive="
                f"{'right' if axis == 'x' else 'down'}, negative="
                f"{'left' if axis == 'x' else 'up'})."
            ),
            "parameters": {
                "type": "object",
                "properties": {
                    "object": {
                        "type": "string",
                        "description": "Object identifier: label text or numeric id.",
                    },
                    "pixels": {
                        "type": "integer",
                        "description": "Pixel delta to move by.",
                    },
                },
                "required": ["object", "pixels"],
            },
        },
    }
    for name, axis in (("adjust_x", "x"), ("adjust_y", "y"))
]
