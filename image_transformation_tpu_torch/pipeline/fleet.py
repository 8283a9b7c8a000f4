# Copy of image_transformation_tpu/pipeline/fleet.py (host helpers copied; run_fleet and main ported to torch).
"""Fleet runner: render a matrix of bundles x aspect ratios on one GPU.

The reference has no batch mode at all — every canvas is one sequential
CLI run (/root/reference/macro_placement_test.py:1715-1745). Here a fleet
of bundles ingests through the native PNG loader, and each bundle's layout
solves and composes for EVERY requested ratio in one fused device pass
(solve -> background -> compose -> stats, pipeline/fused.py): K2 on a CUDA
device with ``kernel="pallas"`` (the default), its plain version on the
CPU. A K2 failure raises; nothing falls back to the plain compose. With a
mesh (``mesh=``, ``--mesh`` under ``torchrun``) the ratio variants shard
over the ranks (``make_sharded_fused_render``, one process per GPU) and
rank 0 writes the artifacts.

Layout source per bundle, in priority order:
1. an explicit layout JSON (``--layout-json`` applied to all bundles, or a
   per-bundle ``fleet_layout.json`` inside the bundle directory);
2. a previous run's final layout under ``output_macro_placement/<stem>``;
3. the deterministic fallback: a single column of all objects in id order
   (the same canned layout the CLI's ``--api fake`` planner uses).

Usage:
    python -m image_transformation_tpu_torch.pipeline.fleet \
        --bundles data/squarespace,data/audio_book \
        --ratios 9:16,1:1,16:9,4:1 --output-root fleet_out [--device cpu]
    torchrun --nproc-per-node N -m image_transformation_tpu_torch.pipeline.fleet \
        --mesh --dist-backend nccl --bundles ... --ratios ...
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device


def _fallback_layout(items: List[dict]) -> Dict:
    children = [
        {"object_id": int(it["object_id"]), "name": str(it.get("label", "")).strip()}
        for it in sorted(items, key=lambda it: int(it["object_id"]))
    ]
    return {"root": {"type": "flex", "direction": "column", "children": children}}


def _unique_stems(bundle_dirs: Sequence[Path]) -> Dict[Path, str]:
    """Stable unique output stem per bundle dir: two dirs sharing a
    basename (clientA/promo, clientB/promo) get parent-qualified stems so
    their artifact trees and result keys never collide — under the full
    loop a collision is destructive (run_macro_only PURGES its tree at
    start, so one thread would delete the other's in-flight run).

    Exact duplicates of the SAME directory (any spelling) collapse to one
    entry: rendering a bundle twice in one fleet is redundant, and under
    the full loop two threads on one tree would purge each other. Callers
    iterate the returned dict, so duplicates are skipped, not re-keyed."""
    dirs: List[Path] = []
    seen: set = set()
    for d in map(Path, bundle_dirs):
        key = d.resolve()
        if key not in seen:
            seen.add(key)
            dirs.append(d)
    by_name: Dict[str, int] = {}
    for d in dirs:
        by_name[d.name] = by_name.get(d.name, 0) + 1
    stems: Dict[Path, str] = {}
    used: set = set()
    for d in dirs:
        stem = d.name if by_name[d.name] == 1 else f"{d.parent.name}__{d.name}"
        while stem in used:  # parent names may collide too
            stem += "_"
        used.add(stem)
        stems[d] = stem
    return stems


def _flex_object_ids(node) -> set:
    """Every object_id mentioned anywhere in a flex dict (root included)."""
    ids: set = set()
    stack = [node]
    while stack:
        n = stack.pop()
        if not isinstance(n, dict):
            continue
        if "object_id" in n:
            try:
                ids.add(int(n["object_id"]))
            except (TypeError, ValueError):
                pass
        if "root" in n:
            stack.append(n["root"])
        children = n.get("children")
        if isinstance(children, list):
            stack.extend(children)
    return ids


def _layout_from_previous_run(
    bundle_dir: Path,
    search_roots: Sequence[Path],
    stem: Optional[str] = None,
    bundle_ids: Optional[set] = None,
) -> Optional[Dict]:
    from .artifacts import latest_iteration

    name = bundle_dir.name
    for root in search_roots:
        root = Path(root)
        # Where a previous run of THIS bundle writes its tree: a
        # colliding-basename full loop runs under <root>/<stem>/<name>
        # (run_fleet_loops gives colliders their own output root); a
        # non-colliding run under <root>/<name>. Never read <root>/<name>
        # for a collider — that tree belongs to ANOTHER bundle with the
        # same basename.
        if stem and stem != name:
            bases = [root / stem / name, root / stem]
        else:
            bases = [root / name]
        for base in bases:
            if not base.exists():
                continue
            last = latest_iteration(base)
            if last is None:
                continue
            for idx in range(last, -1, -1):
                state = (
                    base / f"iteration_{idx:02d}" / "layout_json"
                    / "loop_state.json"
                )
                if not state.exists():
                    continue
                try:
                    flex = json.loads(state.read_text()).get("flex_raw") or {}
                except (json.JSONDecodeError, OSError):
                    # a truncated state file (interrupted run) must not
                    # abort the whole fleet — older iterations or the
                    # fallback layout still apply
                    continue
                if "root" not in flex:
                    continue
                if bundle_ids is not None:
                    found = _flex_object_ids(flex)
                    if not found or not found <= set(bundle_ids):
                        # a layout naming ids this bundle doesn't have is
                        # some OTHER bundle's tree (basename reuse across
                        # runs) — using it would render wrong or crash
                        continue
                return flex
    return None


def resolve_layout(
    bundle_dir: Path,
    items: List[dict],
    layout_json: Optional[Path],
    output_root: Optional[Path] = None,
    stem: Optional[str] = None,
) -> Tuple[Dict, str]:
    """Pick the layout for one bundle; returns (flex dict, provenance tag).

    Previous-run search covers the fleet's own output root (where
    ``--full-loop`` writes) and the default pipeline root, keyed by the
    bundle's unique STEM (colliding basenames never read each other's
    trees) and validated against the bundle's object ids.
    """
    if layout_json is not None:
        return json.loads(Path(layout_json).read_text()), f"file:{layout_json}"
    local = bundle_dir / "fleet_layout.json"
    if local.exists():
        return json.loads(local.read_text()), "bundle:fleet_layout.json"
    roots = [r for r in (output_root, Path.cwd() / "output_macro_placement") if r]
    ids = {int(it["object_id"]) for it in items if "object_id" in it}
    prev = _layout_from_previous_run(bundle_dir, roots, stem=stem,
                                     bundle_ids=ids)
    if prev is not None:
        return prev, "previous_run"
    return _fallback_layout(items), "fallback:column"


def run_fleet(
    bundle_dirs: Sequence[Path],
    ratios: Sequence[str],
    output_root: Optional[Path] = None,
    layout_json: Optional[Path] = None,
    mesh=None,
    save: bool = True,
    pixel_budget_size: Optional[Tuple[int, int]] = None,
    reps: int = 1,
    kernel: str = "pallas",
    device="cuda",
) -> Dict:
    """Render every bundle at every ratio on ``device``; returns a summary
    dict.

    One fused step per bundle (its layout structure is static); the ratio
    variants are its leading axis. ``reps`` > 1 re-runs the device step for
    stable throughput numbers, after one warm-up run; each timing ends in
    ``torch.cuda.synchronize`` on a CUDA device. ``kernel="pallas"`` runs
    K2 on a CUDA device and raises if it fails; "xla" runs the plain
    compose. ``device`` defaults to "cuda" and raises without a card.

    With ``mesh`` (a ``parallel.mesh.Mesh``; every rank calls this) the run
    is on ``mesh.device``: the variants pad to a multiple of the mesh's
    ranks (``pad_ragged_variants``, the padding masked out of the luma),
    each rank renders its shard with ``make_sharded_fused_render``, and
    every rank gathers the canvases and boxes; rank 0 writes the same tree,
    PNGs and boxes as a single-device run.
    """
    reps = max(1, int(reps))
    dev = mesh.device if mesh is not None else resolve_device(str(device))

    from ..core.bundle import load_bundle
    from ..core.native_io import save_png
    from ..layout.canvas import compute_canvas_size
    from ..layout.solve import FlexProgram
    from ..ops.background import masked_median_rgb
    from ..parallel.mesh import shard_batched
    from .fused import (make_fused_render, make_sharded_fused_render, map_bundle_to_program,
                        pad_ragged_variants)

    def fence() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    output_root = Path(output_root) if output_root else Path.cwd() / "fleet_out"
    ratios = list(ratios)
    n_dev = mesh.size() if mesh is not None else 1
    save = save and (mesh is None or mesh.rank == 0)

    summary: Dict = {"bundles": {}, "ratios": ratios, "devices": n_dev, "device": str(dev),
                     "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                                     else "cpu")}
    total_canvases = 0
    total_device_s = 0.0
    t_start = time.perf_counter()

    stems = _unique_stems([Path(d) for d in bundle_dirs])
    for bundle_dir, stem in stems.items():  # deduped, insertion order
        bundle = load_bundle(bundle_dir)
        flex, layout_src = resolve_layout(
            bundle_dir, bundle.items, layout_json, output_root=output_root,
            stem=stem,
        )
        if "root" not in flex:
            raise ValueError(f"layout for {bundle_dir} has no 'root'")

        base_size = pixel_budget_size or bundle.background.size
        sizes_wh = [compute_canvas_size(base_size, r, verbose=False) for r in ratios]
        w_max = max(w for w, _ in sizes_wh)
        h_max = max(h for _, h in sizes_wh)

        arrays = bundle.to_arrays()
        prog = FlexProgram.from_dsl(flex["root"])
        obj_pad = (arrays.objects.shape[1], arrays.objects.shape[2])
        objs, obj_wh, known = map_bundle_to_program(prog, bundle, arrays)

        median = masked_median_rgb(torch.from_numpy(np.array(bundle.background)).to(dev))
        canvas_wh = np.asarray(sizes_wh, np.int32)
        if mesh is not None:
            # the variant batch tiles the mesh: pad, and mask the padding
            # out of the run-level luminance
            canvas_wh, valid = pad_ragged_variants(canvas_wh, n_dev)
        # upload ONCE: the object tensor is the largest host array in the loop
        args = (
            torch.from_numpy(canvas_wh).to(dev),
            median.to(torch.uint8),
            torch.from_numpy(objs).to(dev),
            torch.from_numpy(obj_wh).to(dev),
            torch.from_numpy(known).to(dev),
        )
        if mesh is not None:
            args = args + (torch.from_numpy(valid).to(dev),)
            step = make_sharded_fused_render(mesh, prog, (h_max, w_max), obj_pad, masked=True,
                                             kernel=kernel)
        else:
            step = make_fused_render(prog, (h_max, w_max), obj_pad, kernel=kernel)
        result = step(*args)  # warm-up (and the first K2 build)
        fence()
        t0 = time.perf_counter()
        for _ in range(reps):
            result = step(*args)
        fence()
        device_s = (time.perf_counter() - t0) / reps
        out, boxes = result[0], result[1]
        if mesh is not None:
            batch = shard_batched(mesh)
            out, boxes = batch.gather(out), batch.gather(boxes)

        out_np = out.cpu().numpy()
        boxes_np = boxes.cpu().numpy()
        bdir = output_root / stem
        renders = {}
        for i, r in enumerate(ratios):
            w, h = sizes_wh[i]
            renders[r] = out_np[i, :h, :w]
            if save:
                bdir.mkdir(parents=True, exist_ok=True)
                save_png(renders[r], bdir / f"variant_{r.replace(':', 'x')}.png")
        if save:
            bdir.mkdir(parents=True, exist_ok=True)
            (bdir / "fleet_layout_used.json").write_text(json.dumps(flex, indent=2))
            (bdir / "boxes.json").write_text(json.dumps(
                {r: boxes_np[i].tolist() for i, r in enumerate(ratios)}, indent=2
            ))

        total_canvases += len(ratios) * reps
        total_device_s += device_s * reps
        summary["bundles"][stem] = {
            "layout_source": layout_src,
            "objects": int(arrays.n_valid),
            "canvas_sizes": {r: list(sizes_wh[i]) for i, r in enumerate(ratios)},
            "seconds_per_pass": device_s,
        }

    wall = time.perf_counter() - t_start
    summary["total_canvases"] = total_canvases
    summary["device_seconds"] = total_device_s
    summary["wall_seconds"] = wall
    summary["canvases_per_sec_device"] = (
        total_canvases / total_device_s if total_device_s else 0.0
    )
    if save:
        output_root.mkdir(parents=True, exist_ok=True)
        (output_root / "fleet_summary.json").write_text(json.dumps(summary, indent=2))
    return summary


def install_generic_fake_client() -> None:
    """Register a bundle-agnostic hermetic VLM: plans a single column of
    whatever objects the prompt's summary lists (parsed back from the
    ``id=N, name='...'`` lines personas emit), critiques with a canned
    score. Lets one registration serve a whole fleet of different bundles.
    """
    import re

    from ..vlm.client import FakeClient, register_fake_client

    def scripted(messages, **kwargs):
        text = "\n".join(
            m.get("content", "") for m in messages if isinstance(m.get("content"), str)
        )
        if "critic" in (messages[0].get("content", "") if messages else "").lower():
            return {"message": {"content": "1. Overall Score: 8/10\nNo violations."}}
        ids = sorted({int(m) for m in re.findall(r"id=(\d+),", text)})
        names = dict(re.findall(r"id=(\d+), name='([^']*)'", text))
        layout = {"root": {"type": "flex", "direction": "column", "children": [
            {"object_id": i, "name": names.get(str(i), "")} for i in ids
        ]}}
        return {"message": {"content": json.dumps(layout)}}

    register_fake_client(lambda: FakeClient([scripted]))


def run_fleet_loops(
    bundle_dirs: Sequence[Path],
    ratio: str,
    align: str = "center",
    margin: float = 0.05,
    parallel: int = 4,
    base_output_root: Optional[Path] = None,
    **run_kwargs,
) -> Dict[str, Dict]:
    """Run the FULL iterate loop (planner->critic->refiner->compose) for
    many bundles concurrently.

    The reference runs one sequential loop per CLI invocation; its
    wall-clock is dominated by VLM round-trips (tens of seconds each —
    SURVEY §3.1). Threads overlap the network waits across bundles while
    the device work (already asynchronous dispatches) interleaves on the
    chip. Artifact trees are per-bundle, so runs never collide.

    Returns {bundle_stem: {"output": str} | {"error": str}}.
    """
    from concurrent.futures import ThreadPoolExecutor

    from .run import run_macro_only

    results: Dict[str, Dict] = {}
    stems = _unique_stems([Path(d) for d in bundle_dirs])
    dirs = list(stems)  # deduped: two threads must never share one tree

    def one(bundle_dir: Path) -> None:
        stem = stems[bundle_dir]
        try:
            # colliding basenames get their OWN output root: run_macro_only
            # names (and purges!) its tree by bundle_dir.name, so two
            # threads sharing a name would destroy each other's runs
            root = base_output_root
            if stem != bundle_dir.name:
                root = Path(root or "output_macro_placement") / stem
            out = run_macro_only(
                bundle_dir, ratio, align, margin,
                base_output_root=root, **run_kwargs,
            )
            results[stem] = {"output": str(out)}
        except Exception as e:  # noqa: BLE001 - per-bundle isolation
            results[stem] = {"error": str(e)}

    with ThreadPoolExecutor(max_workers=max(1, parallel)) as pool:
        list(pool.map(one, dirs))
    return results


def _discover_bundles(root: Path) -> List[Path]:
    found = []
    for child in sorted(root.iterdir()):
        if child.is_dir() and (child / "results.json").exists() and (
            child / "background.png"
        ).exists():
            found.append(child)
    if not found:
        raise FileNotFoundError(f"no bundles under {root}")
    return found


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Render a fleet of bundles at several aspect ratios on one GPU."
    )
    parser.add_argument("--bundles", help="Comma-separated bundle directories")
    parser.add_argument("--bundles-root", help="Directory whose child dirs are bundles")
    parser.add_argument("--ratios", default="9:16,1:1,16:9,4:1")
    parser.add_argument("--output-root", default="fleet_out")
    parser.add_argument("--layout-json", default=None,
                        help="Flex-DSL JSON applied to every bundle")
    parser.add_argument("--pixel-budget", default=None,
                        help="WxH pixel budget (e.g. 3840x2160); default: each "
                             "bundle's original size")
    parser.add_argument("--mesh", action="store_true",
                        help="Shard ratio variants over the ranks of the process group "
                             "(torchrun: one process per GPU; a world of one without it)")
    parser.add_argument("--dist-backend", choices=["nccl", "gloo"], default="nccl",
                        help="--mesh collective backend (nccl on cards, gloo on the CPU)")
    parser.add_argument("--reps", type=int, default=1)
    parser.add_argument(
        "--kernel", choices=["xla", "pallas"], default="pallas",
        help="compose path: the gen-3 fused kernel K2 (default; raises if it "
             "fails) or the plain compose",
    )
    parser.add_argument("--no-save", action="store_true")
    parser.add_argument(
        "--full-loop", action="store_true",
        help=(
            "Run the COMPLETE iterate loop (planner/critic/refiner via the "
            "VLM) per bundle, overlapped across --parallel threads, instead "
            "of rendering saved/fallback layouts. Uses the first --ratios "
            "entry."
        ),
    )
    parser.add_argument("--parallel", type=int, default=4)
    parser.add_argument(
        "--api", choices=["auto", "ollama", "nebius", "fake"], default="auto",
        help="--full-loop VLM backend; 'fake' is hermetic (generic planner)",
    )
    parser.add_argument("--refine-iters", type=int, default=10)
    parser.add_argument(
        "--device", default="cuda",
        help="Device for the pixel work: 'cuda' (default; raises without a card) or 'cpu'",
    )
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    if args.bundles:
        bundle_dirs = [Path(p.strip()) for p in args.bundles.split(",") if p.strip()]
    elif args.bundles_root:
        bundle_dirs = _discover_bundles(Path(args.bundles_root))
    else:
        parser.error("one of --bundles or --bundles-root is required")

    ratios = [r.strip() for r in args.ratios.split(",") if r.strip()]
    if args.full_loop:
        ignored = [
            flag for flag, hit in (
                ("--mesh", args.mesh),
                ("--reps", args.reps != 1),
                ("--pixel-budget", bool(args.pixel_budget)),
                ("--layout-json", bool(args.layout_json)),
                ("--no-save", args.no_save),
            ) if hit
        ]
        if ignored:
            parser.error(
                f"--full-loop does not support {', '.join(ignored)} (the "
                "iterate loop plans its own layouts and always persists "
                "artifacts); drop the flag(s) or run without --full-loop"
            )
        if len(ratios) > 1:
            parser.error("--full-loop takes exactly one ratio in --ratios")
        api_type = args.api
        if api_type == "fake":
            install_generic_fake_client()
            api_type = "auto"
        results = run_fleet_loops(
            bundle_dirs, ratios[0], parallel=args.parallel,
            refine_iters=args.refine_iters, api_type=api_type,
            base_output_root=Path(args.output_root), device=device,
        )
        print(json.dumps({
            "bundles": len(results),
            "ok": sum(1 for r in results.values() if "output" in r),
            "errors": {k: v["error"] for k, v in results.items() if "error" in v},
        }))
        return

    mesh = None
    if args.mesh:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(device=args.device, backend=args.dist_backend)

    budget = None
    if args.pixel_budget:
        w, h = args.pixel_budget.lower().split("x")
        budget = (int(w), int(h))

    try:
        summary = run_fleet(
            bundle_dirs,
            ratios,
            output_root=Path(args.output_root),
            layout_json=Path(args.layout_json) if args.layout_json else None,
            mesh=mesh,
            save=not args.no_save,
            pixel_budget_size=budget,
            reps=args.reps,
            kernel=args.kernel,
            device=device,
        )
    finally:
        if mesh is not None:
            mesh.close()
    if mesh is not None and mesh.rank != 0:
        return
    print(json.dumps({
        "bundles": len(summary["bundles"]),
        "ratios": summary["ratios"],
        "total_canvases": summary["total_canvases"],
        "canvases_per_sec_device": round(summary["canvases_per_sec_device"], 2),
    }))


if __name__ == "__main__":
    main()
