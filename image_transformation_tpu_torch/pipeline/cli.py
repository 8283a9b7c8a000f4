"""CLI entry point of the PyTorch/CUDA port.

Port of image_transformation_tpu/pipeline/cli.py: the same flags and
defaults as the reference macro_placement_test CLI (--image, --ratio,
--align center|edge, --margin 0.05, --api auto|ollama|nebius, --samples,
--temperature 1.0, --refine-iters 10), plus --bundle, --api fake (a
hermetic run with a canned planner), --resume, --background and
--output-root and --variants (after the run, re-render the final layout
at every ratio in one fused pass into variants/), and one flag of its own:

    --device cuda|cpu   where the pixel work runs (default cuda; raises
                        when CUDA is asked for and no card is present)

Run it as ``python -m image_transformation_tpu_torch.pipeline.cli``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..core.device import resolve_device
from .run import run_macro_only


def install_fake_client(bundle_dir: Path) -> None:
    """Wire a deterministic FakeClient: single-column layout + canned critique."""
    from ..vlm.client import FakeClient, register_fake_client

    items = json.loads((bundle_dir / "results.json").read_text())
    children = [
        {"object_id": int(it["object_id"]), "name": str(it.get("label", "")).strip()}
        for it in items
    ]
    layout = {"root": {"type": "flex", "direction": "column", "children": children}}

    def scripted(messages, **kwargs):
        # Dispatch on the LAST system-role message: the agentic nodes
        # append their system prompt last (messages[0] there is the layout
        # JSON, which would misroute), while only the critic personas'
        # SYSTEM prompts mention "critic" — the refiner/micro user turns
        # quote critic feedback and must still receive layout JSON.
        sys_msgs = [
            m for m in (messages or []) if m.get("role") == "system"
        ]
        probe = sys_msgs[-1] if sys_msgs else (messages[0] if messages else {})
        if "critic" in str(probe.get("content", "")).lower():
            return {"message": {"content": "1. Overall Score: 8/10\nLooks fine. No violations."}}
        return {"message": {"content": json.dumps(layout)}}

    register_fake_client(lambda: FakeClient([scripted]))


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser(
        description=(
            "Macro placement using VLM Flex-DSL with iterative refinement "
            "and the deterministic compositor (PyTorch/CUDA)."
        )
    )
    parser.add_argument("--image", help="Path to input image used with the auto-segmenter")
    parser.add_argument("--bundle", help="Path to a segmentation bundle directory")
    parser.add_argument("--ratio", required=True, help="Target aspect ratio W:H (e.g., 9:16)")
    parser.add_argument("--align", default="center", choices=["center", "edge"])
    parser.add_argument("--margin", type=float, default=0.05, help="Safe margin percentage (0-0.3)")
    parser.add_argument(
        "--api", choices=["auto", "ollama", "nebius", "fake"], default="auto",
        help="VLM backend ('fake' runs hermetically with a canned planner)",
    )
    parser.add_argument("--samples", type=int, default=1)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--refine-iters", type=int, default=10)
    parser.add_argument("--resume", action="store_true", help="Continue from the last iteration")
    parser.add_argument(
        "--background", choices=["solid", "gradient"], default="solid",
        help=(
            "Canvas synthesis: 'solid' = median color (reference behavior); "
            "'gradient' = edge-strip linear gradient (the reference's "
            "fill_gradient, exposed as a first-class option)"
        ),
    )
    parser.add_argument("--output-root", default=None, help="Artifact root directory")
    parser.add_argument(
        "--variants",
        default=None,
        help=(
            "Comma-separated extra aspect ratios (e.g. 1:1,16:9,4:1): after "
            "the run, re-render the final layout at every ratio in ONE fused "
            "device pass (solve+background+compose) into variants/"
        ),
    )
    parser.add_argument(
        "--device", default="cuda",
        help="Device for the pixel work: 'cuda' (default; raises without a card) or 'cpu'",
    )
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    if args.bundle:
        bundle_dir = Path(args.bundle).resolve()
        original_input = None
    elif args.image:
        image_path = Path(args.image).resolve()
        bundle_dir = image_path.parent.parent / "output" / image_path.stem
        original_input = str(image_path)
    else:
        parser.error("one of --image or --bundle is required")
    if not bundle_dir.exists():
        raise FileNotFoundError(f"Expected segmentation outputs at {bundle_dir}")

    api_type = args.api
    if api_type == "fake":
        install_fake_client(bundle_dir)
        api_type = "auto"

    base_out = run_macro_only(
        bundle_dir,
        args.ratio,
        args.align,
        args.margin,
        api_type=api_type,
        samples=args.samples,
        temperature=args.temperature,
        refine_iters=args.refine_iters,
        original_input_path=original_input,
        base_output_root=Path(args.output_root) if args.output_root else None,
        resume=args.resume,
        background=args.background,
        device=device,
    )

    if args.variants:
        ratios = [args.ratio] + [
            r.strip() for r in args.variants.split(",") if r.strip()
        ]
        render_variants(bundle_dir, base_out, ratios, background=args.background,
                        device=device)
    return base_out


def render_variants(bundle_dir: Path, base_out: Path, ratios,
                    background: str = "solid", device="cuda") -> Path:
    """Re-render the run's final layout at several ratios in one fused
    pass on ``device`` (K2 on a CUDA device); writes
    ``variants/variant_WxH.png`` under the run dir and returns that dir."""
    from ..core.bundle import load_bundle
    from ..core.native_io import save_png
    from .artifacts import latest_iteration
    from .fused import fused_multi_ratio_render

    last = latest_iteration(base_out)
    if last is None:
        raise FileNotFoundError(f"no iterations under {base_out}")
    flex_json = None
    for idx in range(last, -1, -1):
        state = base_out / f"iteration_{idx:02d}" / "layout_json" / "loop_state.json"
        if state.exists():
            flex_json = json.loads(state.read_text()).get("flex_raw")
            if flex_json and "root" in flex_json:
                break
    if not flex_json or "root" not in flex_json:
        raise RuntimeError(f"no solved layout found under {base_out}")

    bundle = load_bundle(bundle_dir)
    renders, _boxes = fused_multi_ratio_render(
        bundle, flex_json["root"], ratios, background=background, device=device
    )
    out_dir = base_out / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for ratio, arr in renders.items():
        path = out_dir / f"variant_{ratio.replace(':', 'x')}.png"
        save_png(arr, path)
        print(f"[variants] {ratio}: {arr.shape[1]}x{arr.shape[0]} -> {path}")
    return out_dir


if __name__ == "__main__":
    main()
