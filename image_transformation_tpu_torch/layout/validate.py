# Copy of image_transformation_tpu/layout/validate.py (host-only; imports rewritten to this package).
"""Flex-DSL validation, sanitize modes, and nesting-conflict precomputation.

Validation parity target: reference/macro_placement_test.py:388-634.

Known divergence (intentional, documented in SURVEY.md §2.6.1): the
reference's `_validate_flex_dsl` contains an indentation bug that makes its
recursive check dead code — as-run, every validation raises a coverage
mismatch and callers fall back to retry paths. This module implements the
validator *as specified*: the walk actually runs, sanitize modes actually
strip fields, and the coverage/conflict checks see real data. The
orchestrator preserves the reference's *failure handling* (persist error,
retry-once with feedback) for when validation legitimately fails.

Structure: a mode dataclass + styling-snapshot policy pass per container,
an in-order tree walk collecting leaf ids, and a separate post-order
conflict sweep — rather than one large nested closure. Error strings match
the reference (they are part of the retry-prompt protocol).

Spec-inherited gap (kept for parity, not fixed): an object whose bundle
label is EMPTY skips the name-must-match check (the reference does the
same), so its VLM-chosen leaf name can never match the ``id_N``-keyed
conflict pairs computed from labels — nesting-conflict validation is
silently toothless for unlabeled objects. Real bundles always carry
labels; fixing it would change the retry-prompt protocol vs the
reference.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from .flex import (
    ALLOWED_ALIGN,
    ALLOWED_DIRECTION,
    ALLOWED_JUSTIFY,
    FlexError,
    sanitize_offset,
    sanitize_padding,
    sanitize_pin,
    sanitize_stick_to,
)

LabelPair = Tuple[str, str]


def extract_json_maybe(content: str) -> str:
    """Strip one markdown fence and slice the outermost JSON object."""
    text = content.strip()
    if text.startswith("```"):
        fenced = text.split("```", 2)
        if len(fenced) >= 3:
            text = fenced[1]
    lo, hi = text.find("{"), text.rfind("}")
    return text[lo : hi + 1] if 0 <= lo < hi else text


def parse_flex_response(raw_text: str) -> Dict:
    """Parse a VLM response into a DSL dict, or an error sentinel."""
    try:
        return json.loads(extract_json_maybe(raw_text))
    except Exception:
        return {"error": "invalid_json", "raw": raw_text[:1000]}


# --------------------------------------------------------------------------
# Validation modes and per-container styling policy
# --------------------------------------------------------------------------

MAX_DEPTH = 2
_SPACING_KEYS = ("gap_px", "padding_px")
_ALIGN_KEYS = ("justify", "align")

# Per-object tuning fields and their checkers (flex.py sanitizers raise
# FlexError with the reference's wording).
_TUNING_CHECKS: Dict[str, Callable] = {
    "padding_px": sanitize_padding,
    "pin": sanitize_pin,
    "offset_px": sanitize_offset,
    "stick_to": sanitize_stick_to,
}


@dataclass(frozen=True)
class Mode:
    """The six validator flags (same semantics as the reference's kwargs)."""

    object_tuning: bool = False
    container_spacing: bool = False
    container_align: bool = False
    freeze_root: bool = False
    drop_styling: bool = False
    sanitize: bool = False


class _Styling:
    """Snapshot of a container's styling fields.

    Policy decisions are made against the snapshot (presence + value at
    entry), while strips mutate the underlying node — mirroring the
    reference's present/value local-variable discipline, including the
    quirk that the final integer check validates the *captured* gap/pad
    even when sanitize already removed the keys.
    """

    def __init__(self, node: Dict):
        self.node = node
        self.present = {k: k in node for k in _SPACING_KEYS + _ALIGN_KEYS}
        self.gap = node.get("gap_px", 0)
        self.pad = node.get("padding_px", 0)
        self.justify = node.get("justify", "center")
        self.align = node.get("align", "center")

    def strip(self, *keys: str) -> None:
        for k in keys:
            self.node.pop(k, None)
            self.present[k] = False

    def clear_all(self) -> None:
        self.strip(*_SPACING_KEYS, *_ALIGN_KEYS)
        self.gap = self.pad = 0
        self.justify = self.align = "center"

    def off_center(self, key: str) -> bool:
        value = self.justify if key == "justify" else self.align
        return self.present[key] and value not in (None, "center")


def _apply_container_policy(st: _Styling, mode: Mode, is_root: bool) -> None:
    """Enforce/strip styling per the mode flags. Order of rules matches the
    reference: whitelist, drop, align policy, root freeze, spacing policy,
    integer checks."""
    if st.justify not in ALLOWED_JUSTIFY:
        raise FlexError("invalid justify")
    if st.align not in ALLOWED_ALIGN:
        raise FlexError("invalid align")

    if mode.drop_styling and mode.sanitize:
        st.clear_all()

    if not mode.container_align:
        if st.off_center("justify") or st.off_center("align"):
            if not mode.sanitize:
                raise FlexError("container align/justify not allowed in this mode")
            st.strip(*_ALIGN_KEYS)
        elif mode.sanitize:
            # drop redundant center/None values too
            st.strip(*(k for k in _ALIGN_KEYS if st.present[k]))

    if mode.freeze_root and is_root:
        if (st.present["gap_px"] and st.gap != 0) or (
            st.present["padding_px"] and st.pad != 0
        ):
            raise FlexError("root container cannot set gap_px or padding_px")
        if mode.sanitize:
            st.strip(*_SPACING_KEYS)
        if st.present["justify"] and st.justify != "center":
            raise FlexError("root container cannot change justify")
        if st.present["align"] and st.align != "center":
            raise FlexError("root container cannot change align")
        if mode.sanitize:
            st.strip(*_ALIGN_KEYS)

    if not mode.container_spacing and not mode.drop_styling:
        for key, value in (("gap_px", st.gap), ("padding_px", st.pad)):
            if st.present[key] and value not in (0, None):
                raise FlexError(f"{key} not allowed in this mode")
        if mode.sanitize:
            st.strip(*_SPACING_KEYS)

    for key, value in (("gap_px", st.gap), ("padding_px", st.pad)):
        if not isinstance(value, int) or isinstance(value, bool) or value < 0:
            raise FlexError(f"{key} must be non-negative int")


def _check_object_leaf(ch: Dict, mode: Mode, id_to_label: Dict[int, str]) -> int:
    """Validate one object child; returns its id."""
    oid = int(ch["object_id"])
    name = ch.get("name")
    if not isinstance(name, str) or not name:
        raise FlexError(f"missing or invalid 'name' for object_id {oid}")
    known = id_to_label.get(oid, "").strip()
    if known and name.strip() != known:
        raise FlexError(
            f"name mismatch for object_id {oid}: got '{name}', expected '{known}'"
        )
    if mode.object_tuning:
        for key, check in _TUNING_CHECKS.items():
            if ch.get(key) is not None:
                check(ch[key], oid)
    else:
        extras = set(ch) - {"object_id", "name"}
        if extras and not mode.sanitize:
            raise FlexError(
                f"object_id {oid} includes unsupported fields "
                f"{sorted(extras)} in baseline mode"
            )
        for key in extras:
            ch.pop(key, None)
    return oid


@dataclass
class _WalkState:
    mode: Mode
    id_to_label: Dict[int, str]
    seen_ids: List[int] = field(default_factory=list)
    containers: List[Dict] = field(default_factory=list)  # post-order


def _walk_container(node: Dict, depth: int, ws: _WalkState) -> None:
    if depth > MAX_DEPTH:
        raise FlexError(f"Nesting depth > {MAX_DEPTH} not allowed")
    if node.get("type") != "flex":
        raise FlexError("Only type=flex containers supported")
    if node.get("direction") not in ALLOWED_DIRECTION:
        raise FlexError("direction must be 'row' or 'column'")

    _apply_container_policy(_Styling(node), ws.mode, is_root=depth == 1)

    children = node.get("children", [])
    if not isinstance(children, list) or not children:
        raise FlexError("flex container must have children")
    for ch in children:
        if not isinstance(ch, dict):
            raise FlexError("child must be object")
        if "object_id" in ch:
            ws.seen_ids.append(_check_object_leaf(ch, ws.mode, ws.id_to_label))
        else:
            _walk_container(ch, depth + 1, ws)
    ws.containers.append(node)


# --------------------------------------------------------------------------
# Cross-child nesting-conflict sweep
# --------------------------------------------------------------------------


def _leaf_names(node: Dict) -> List[str]:
    """All object names under a node (itself if an object leaf)."""
    if not isinstance(node, dict):
        return []
    if "object_id" in node:
        nm = node.get("name")
        return [nm] if isinstance(nm, str) and nm else []
    return [
        name
        for sub in node.get("children", []) or []
        for name in _leaf_names(sub)
    ]


def _conflict_violations(
    node: Dict,
    row_bad_pairs: Optional[Set[frozenset]],
    col_bad_pairs: Optional[Set[frozenset]],
) -> List[str]:
    """Cartesian cross-child check: a bad pair split across two children of
    the same container still violates the axis constraint (prevents bypass
    via grouping)."""
    by_axis = {"row": ("Row", row_bad_pairs), "column": ("Column", col_bad_pairs)}
    word, bad_pairs = by_axis.get(node.get("direction"), ("", None))
    if not bad_pairs:
        return []
    groups = [_leaf_names(ch) for ch in node.get("children", []) or []]
    return [
        f"{word} container indirectly nests non-nestable pair via grouping: {a} + {b}"
        for ga, gb in itertools.combinations(groups, 2)
        for a, b in itertools.product(ga, gb)
        if frozenset({a, b}) in bad_pairs
    ]


# --------------------------------------------------------------------------
# Public surface
# --------------------------------------------------------------------------


def validate_flex_dsl(
    data: Dict,
    required_obj_ids: List[int],
    id_to_label: Dict[int, str],
    row_bad_pairs: Optional[Set[frozenset]] = None,
    col_bad_pairs: Optional[Set[frozenset]] = None,
    *,
    allow_object_tuning: bool = False,
    allow_container_spacing: bool = False,
    allow_container_align: bool = False,
    forbid_root_spacing: bool = False,
    drop_container_styling: bool = False,
    sanitize: bool = False,
) -> Tuple[Dict, List[int]]:
    """Validate (and optionally sanitize in place) a Flex-DSL document.

    Returns (data, seen_ids). Raises FlexError on any violation.
    """
    if not isinstance(data, dict):
        raise FlexError("DSL root must be an object")
    if "root" not in data:
        raise FlexError("Missing root container")
    root = data["root"]
    if not isinstance(root, dict):
        raise FlexError("root must be an object")

    ws = _WalkState(
        mode=Mode(
            object_tuning=allow_object_tuning,
            container_spacing=allow_container_spacing,
            container_align=allow_container_align,
            freeze_root=forbid_root_spacing,
            drop_styling=drop_container_styling,
            sanitize=sanitize,
        ),
        id_to_label=id_to_label,
    )
    _walk_container(root, 1, ws)

    if sorted(ws.seen_ids) != sorted(required_obj_ids):
        raise FlexError(
            f"object_id coverage mismatch. seen={sorted(ws.seen_ids)}, "
            f"required={sorted(required_obj_ids)}"
        )
    violations = [
        v
        for container in ws.containers
        for v in _conflict_violations(container, row_bad_pairs, col_bad_pairs)
    ]
    if violations:
        raise FlexError("; ".join(violations))
    return data, ws.seen_ids


def compute_nesting_conflicts(
    labels: List[str],
    sizes: List[Tuple[int, int]],
    canvas_size: Tuple[int, int],
    margin_pct: float,
) -> Tuple[List[LabelPair], List[LabelPair]]:
    """Pairs of labels that cannot share a row (widths) / column (heights).

    Pure-data variant of the reference's file-reading version
    (macro_placement_test.py:587-634); core.bundle supplies labels/sizes.
    """
    w, h = canvas_size
    inner_w = max(1, int(w - 2 * (margin_pct * w)))
    inner_h = max(1, int(h - 2 * (margin_pct * h)))
    min_gap = max(8, int(min(w, h) * 0.01))

    def overflows(a: int, b: int, inner: int) -> bool:
        return a >= inner or b >= inner or (a + b + min_gap) > inner

    row_bad: Set[LabelPair] = set()
    col_bad: Set[LabelPair] = set()
    for (la, (wa, ha)), (lb, (wb, hb)) in itertools.combinations(
        zip(labels, sizes), 2
    ):
        pair = tuple(sorted((la, lb)))
        if overflows(wa, wb, inner_w):
            row_bad.add(pair)
        if overflows(ha, hb, inner_h):
            col_bad.add(pair)
    return sorted(row_bad), sorted(col_bad)
