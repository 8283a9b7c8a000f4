# Copy of image_transformation_tpu/ui/console.py (host-only; the module path in the usage lines is this package's).
"""Textual artifact browser — the no-streamlit fallback UI.

The Streamlit apps (ui/app.py, ui/agentic_app.py) are code-complete but
streamlit is not installed in every environment; this console browser
exposes the same artifact surface (the per-iteration tree run_macro_only
persists — SURVEY.md §2.4) as plain text:

    python -m image_transformation_tpu_torch.ui.console list
    python -m image_transformation_tpu_torch.ui.console show <stem> [--iter N] [--json]

``list`` enumerates runs under the artifact root with iteration counts;
``show`` prints per-iteration summaries: draft/overlay paths, solved
placements, validation errors, critique text, the no-change marker, and
the run's step-timing log.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional


def _iterations(run_dir: Path) -> List[int]:
    out = []
    for child in sorted(run_dir.glob("iteration_*")):
        try:
            out.append(int(child.name.split("_")[1]))
        except (IndexError, ValueError):
            continue
    return out


def list_runs(root: Path) -> List[Dict]:
    runs = []
    if not root.exists():
        return runs
    for child in sorted(root.iterdir()):
        iters = _iterations(child) if child.is_dir() else []
        if iters:
            runs.append({
                "stem": child.name,
                "iterations": len(iters),
                "last_iteration": max(iters),
                "has_time_log": (child / "time_log.txt").exists(),
            })
    return runs


def _read(path: Path, limit: int = 2000) -> Optional[str]:
    if not path.exists():
        return None
    text = path.read_text(errors="replace").strip()
    return text[:limit] + ("…" if len(text) > limit else "")


def iteration_summary(run_dir: Path, idx: int) -> Dict:
    d = run_dir / f"iteration_{idx:02d}"
    layout = d / "layout_json" / f"layout_macro_iter_{idx:02d}.json"
    summary: Dict = {"iteration": idx, "dir": str(d)}
    draft = d / "final_product" / f"draft_macro_iter_{idx:02d}.png"
    summary["draft"] = str(draft) if draft.exists() else None
    overlay = d / "final_product" / f"overlay_debug_iter_{idx:02d}.png"
    summary["overlay"] = str(overlay) if overlay.exists() else None
    if layout.exists():
        data = json.loads(layout.read_text())
        summary["canvas"] = data.get("canvas")
        summary["placements"] = [
            {"object_id": p.get("object_id"), "name": p.get("name"),
             "box": p.get("box"), "scale": p.get("scale")}
            for p in data.get("placements", [])
        ]
    validation = _read(d / "vlm_input_text" / f"flex_validation_error_iter_{idx:02d}.txt")
    if validation:
        summary["validation_error"] = validation
    critique = _read(d / "vlm_output" / f"critic_raw_iter_{idx:02d}.txt", 800)
    if critique:
        summary["critique"] = critique
    no_change = d / "vlm_input_text" / f"no_change_iter_{idx:02d}.txt"
    if no_change.exists():
        summary["no_change"] = True
    return summary


def show_run(root: Path, stem: str, iteration: Optional[int] = None) -> Dict:
    run_dir = root / stem
    iters = _iterations(run_dir)
    if not iters:
        raise FileNotFoundError(f"no iterations under {run_dir}")
    if iteration is not None and iteration not in iters:
        raise FileNotFoundError(
            f"iteration {iteration} not found under {run_dir} "
            f"(have: {iters})"
        )
    chosen = iters if iteration is None else [iteration]
    report = {
        "stem": stem,
        "iterations": [iteration_summary(run_dir, i) for i in chosen],
        "time_log": _read(run_dir / "time_log.txt"),
    }
    return report


def _print_report(report: Dict) -> None:
    print(f"=== {report['stem']} ===")
    for it in report["iterations"]:
        print(f"\n-- iteration {it['iteration']:02d} --")
        if it.get("no_change"):
            print("  (no change: refiner repeated the previous JSON; compose skipped)")
        if it.get("draft"):
            print(f"  draft:   {it['draft']}")
        if it.get("overlay"):
            print(f"  overlay: {it['overlay']}")
        canvas = it.get("canvas")
        if canvas:
            print(f"  canvas:  {canvas.get('width')}x{canvas.get('height')} "
                  f"margin={canvas.get('margin')} align={canvas.get('align')}")
        for p in it.get("placements", []):
            name = p.get("name") or ""
            print(f"    [{p.get('object_id')}] {name:<16} box={p.get('box')} "
                  f"scale={p.get('scale')}")
        if it.get("validation_error"):
            print(f"  validation error: {it['validation_error'].splitlines()[0]}")
        if it.get("critique"):
            first = it["critique"].splitlines()[0]
            print(f"  critique: {first}")
    if report.get("time_log"):
        print("\n-- timings --")
        print(report["time_log"])


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Textual artifact browser")
    parser.add_argument("--root", default="output_macro_placement",
                        help="Artifact root (run_macro_only's output root)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="List runs")
    show = sub.add_parser("show", help="Show a run's iterations")
    show.add_argument("stem")
    show.add_argument("--iter", type=int, default=None)
    show.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)

    root = Path(args.root)
    if args.cmd == "list":
        runs = list_runs(root)
        if not runs:
            print(f"no runs under {root}")
            return
        for r in runs:
            print(f"{r['stem']:<24} iterations={r['iterations']} "
                  f"last={r['last_iteration']:02d} "
                  f"time_log={'yes' if r['has_time_log'] else 'no'}")
        return

    report = show_run(root, args.stem, args.iter)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        _print_report(report)


if __name__ == "__main__":
    try:
        main()
    except BrokenPipeError:  # e.g. `... show <stem> | head`
        import os
        import sys

        # reopen stdout so the interpreter's shutdown flush doesn't re-raise
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
