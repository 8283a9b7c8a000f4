"""The reference ``macro_placement_test`` module on the port.

Counterpart of the root ``macro_placement_test.py``: every name it defines
or re-exports, the reference's underscore names included, from the port's
modules (the Flex-DSL solver and validator in ``layout``, personas in
``vlm``, the contact sheet in ``ops``, the orchestrator in ``pipeline``).
``main`` is the port's CLI, so ``--device`` defaults to cuda; the contact
sheet takes a ``device`` keyword ("cuda" by default, which raises without
a card; "cpu").

    python -m image_transformation_tpu_torch.compat.macro_placement_test \\
        --bundle data/squarespace --ratio 9:16 --api fake --device cpu
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

from ..core.device import resolve_device
from ..layout.canvas import ratio_family as _ratio_family  # noqa: F401
from ..layout.flex import (  # noqa: F401
    ALLOWED_ALIGN,
    ALLOWED_DIRECTION,
    ALLOWED_JUSTIFY,
    STICK_TO_EDGES,
    clamp_boxes as _clamp_boxes_impl,
    measure_node as _measure_node_impl,
    place_tree as _place_tree_impl,
    sanitize_offset as _sanitize_offset,
    sanitize_padding as _sanitize_padding,
    sanitize_pin as _sanitize_pin,
    sanitize_stick_to as _sanitize_stick_to,
)
from ..layout.validate import (  # noqa: F401
    extract_json_maybe as _extract_json_maybe,
    validate_flex_dsl as _validate_flex_dsl,
)
from ..ops import contact_sheet as _contact_sheet
from ..pipeline.cli import main  # noqa: F401
from ..pipeline.run import run_macro_only  # noqa: F401
from ..vlm.client import encode_pil_b64_png as _encode_pil_to_b64_png  # noqa: F401
from ..vlm.personas import (  # noqa: F401
    best_practices_text as _best_practices_text,
    shared_context_block as _build_shared_prompt_context,
)

SCRIPT_DIR = Path(__file__).parent.resolve()


def _build_labeled_contact_sheet_from_results(
    results_json_path: str,
    thumb_size: Tuple[int, int] = (256, 256),
    cols: int = 4,
    label_height: int = 72,
    font_size: int = 24,
    device: str = "cuda",
):
    """results.json path -> labelled contact sheet, built on ``device``."""
    return _contact_sheet.build_contact_sheet_from_results(
        results_json_path, thumb_size, cols, label_height, font_size,
        device=resolve_device(device),
    )


def _build_labeled_contact_sheet(
    objects_dir: str,
    results_json_path: str,
    thumb_size: Tuple[int, int] = (256, 256),
    cols: int = 4,
    label_height: int = 72,
    font_size: int = 24,
    device: str = "cuda",
):
    """Reference-signature contact sheet (objects_dir is implied by
    results.json, kept for drop-in compatibility)."""
    del objects_dir
    return _build_labeled_contact_sheet_from_results(
        results_json_path, thumb_size, cols, label_height, font_size, device=device
    )


def _image_size_map(images: Dict) -> Dict[int, Tuple[int, int]]:
    return {oid: img.size for oid, img in images.items() if img is not None}


def _measure_flex_node(node: Dict, images: Dict) -> Tuple[int, int]:
    """Intrinsic node size (PIL-images-in signature of the reference)."""
    return _measure_node_impl(node, _image_size_map(images))


def _place_flex_container(
    node: Dict,
    origin: Tuple[int, int],
    size: Tuple[int, int],
    images: Dict,
    placements: List[Dict],
    parent_cell: str,
) -> None:
    """Top-down placement (PIL-images-in signature of the reference)."""
    _place_tree_impl(node, origin, size, _image_size_map(images), placements, parent_cell)


def _clamp_boxes_to_canvas(placements: List[Dict], canvas_size: Tuple[int, int]) -> None:
    _clamp_boxes_impl(placements, canvas_size)


def ensure_dir(path) -> None:
    Path(path).mkdir(parents=True, exist_ok=True)


def read_original_size(output_dir) -> Tuple[int, int]:
    """(width, height) of the bundle's background.png."""
    from PIL import Image

    with Image.open(Path(output_dir) / "background.png") as im:
        return im.size


def _save_overlay_debug(placements: List[Dict], canvas_size: Tuple[int, int], path) -> None:
    from ..pipeline.artifacts import save_overlay_debug

    save_overlay_debug(placements, canvas_size, Path(path))


def _compose_candidates_grid(image_paths, out_path) -> None:
    """2x2 grid of candidate renders (legacy surface; no pipeline callers)."""
    from PIL import Image

    imgs = [Image.open(p).convert("RGBA") for p in image_paths if Path(p).exists()]
    if not imgs:
        return
    ref_w, ref_h = imgs[0].size
    grid = Image.new("RGBA", (ref_w * 2, ref_h * 2), (255, 255, 255, 255))
    positions = [(0, 0), (ref_w, 0), (0, ref_h), (ref_w, ref_h)]
    for im, pos in zip(imgs, positions):
        grid.alpha_composite(im.resize((ref_w, ref_h), Image.LANCZOS), dest=pos)
    grid.save(out_path)


def _compute_nesting_conflicts(
    results_json_path: str, canvas_size: Tuple[int, int], margin_pct: float
):
    """File-reading conflict precomputation (reference signature)."""
    import json

    from PIL import Image

    from ..layout.validate import compute_nesting_conflicts

    results_json_path = Path(results_json_path)
    with open(results_json_path, "r", encoding="utf-8") as f:
        items = json.load(f)
    labels, sizes = [], []
    for it in items:
        labels.append(str(it.get("label", "")).strip() or f"id_{it.get('object_id')}")
        try:
            with Image.open(results_json_path.parent / it["filename"]) as im:
                sizes.append(im.size)
        except Exception:
            x1, y1, x2, y2 = it.get("bounding_box", [0, 0, 0, 0])
            sizes.append((max(0, int(x2 - x1)), max(0, int(y2 - y1))))
    return compute_nesting_conflicts(labels, sizes, canvas_size, margin_pct)


if __name__ == "__main__":
    main()
