# Copy of image_transformation_tpu/pipeline/artifacts.py (host-only; imports rewritten to this package).
"""Per-iteration artifact tree (the de-facto UX contract of the viewer).

Layout parity with the reference run_macro_only
(reference/macro_placement_test.py:1369-1379):

    output_macro_placement/<stem>/iteration_XX/
        final_product/      draft + overlay PNGs
        vlm_input_text/     prompts, metadata, validation errors
        vlm_input_image/    contact sheet, background, canvas, composite_prev
        vlm_output/         raw responses + parsed/failed layouts
        layout_json/        solved placements + provenance
    + time_log.txt at the run root.
"""

from __future__ import annotations

import json
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from PIL import Image, ImageDraw

_OVERLAY_COLORS = [
    (255, 99, 71, 180),
    (135, 206, 235, 180),
    (60, 179, 113, 180),
    (238, 130, 238, 180),
    (255, 215, 0, 180),
    (30, 144, 255, 180),
]


@dataclass
class IterationDirs:
    root: Path
    final: Path
    in_text: Path
    in_image: Path
    vlm_out: Path
    layout: Path


def ensure_dir(path: Path) -> None:
    path.mkdir(parents=True, exist_ok=True)


def iteration_dirs(base: Path, idx: int) -> IterationDirs:
    root = base / f"iteration_{idx:02d}"
    dirs = IterationDirs(
        root=root,
        final=root / "final_product",
        in_text=root / "vlm_input_text",
        in_image=root / "vlm_input_image",
        vlm_out=root / "vlm_output",
        layout=root / "layout_json",
    )
    for d in (dirs.root, dirs.final, dirs.in_text, dirs.in_image, dirs.vlm_out, dirs.layout):
        ensure_dir(d)
    return dirs


def purge_run_dir(base: Path) -> None:
    """Reset a run directory (the reference purges on every run; the
    resume path skips this)."""
    try:
        if base.exists():
            shutil.rmtree(base)
    except Exception:
        pass
    ensure_dir(base)


def write_json(path: Path, data) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2)


def write_text(path: Path, text: str) -> None:
    path.write_text(text, encoding="utf-8")


def copy_file(src, dst) -> None:
    try:
        shutil.copyfile(src, dst)
    except Exception:
        pass


def save_overlay_debug(
    placements: List[Dict], canvas_size: Tuple[int, int], path: Path
) -> None:
    """Colored box-outline overlay PNG for layout debugging."""
    overlay = Image.new("RGBA", canvas_size, (0, 0, 0, 0))
    draw = ImageDraw.Draw(overlay)
    for idx, p in enumerate(placements):
        draw.rectangle(
            list(p["box"]), outline=_OVERLAY_COLORS[idx % len(_OVERLAY_COLORS)], width=3
        )
    overlay.save(path)


def record_failed_output(path: Path, error: str, payload) -> None:
    """Append a validation failure + offending payload for inspection."""
    with open(path, "a", encoding="utf-8") as f:
        f.write(f"validation_error: {error}\n")
        f.write(json.dumps(payload, indent=2))
        f.write("\n---\n")


def latest_iteration(base: Path) -> Optional[int]:
    """Highest iteration_XX index present (for resume)."""
    best = None
    for d in base.glob("iteration_*"):
        try:
            idx = int(d.name.split("_")[1])
        except (IndexError, ValueError):
            continue
        best = idx if best is None else max(best, idx)
    return best
