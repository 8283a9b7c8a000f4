"""The iterate-loop orchestrator: plan → solve → compose → critic → refine.

Port of image_transformation_tpu/pipeline/run.py with an explicit
``device``. Behavior parity with the reference ``run_macro_only``
(reference/macro_placement_test.py:1350-1712): same CLI-visible
parameters and defaults, same artifact tree per iteration, same step-timer
names, same VLM message construction (via vlm.personas), same failure
handling (persist error text, retry-once with validator feedback injected),
and the identical-JSON short-circuit that skips composing an iteration.

Pixel work (background synthesis, contact-sheet thumbnails, compose) runs
on ``device`` through torch; on CUDA the compose launches the hand-written
kernel (pipeline/engine.py). The loop is resumable as in the JAX package.

Known prompt-context quirk preserved: object bbox normalization uses the
*canvas* PNG's size (the reference passes canvas_path as background_path
into its planner — macro_placement_test.py:1443-1444, 1103).
"""

from __future__ import annotations

import base64
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from ..core.bundle import load_bundle
from ..core.device import resolve_device
from ..core.logging import RunLogger
from ..core.timing import StepTimer
from ..layout.canvas import compute_canvas_size
from ..layout.flex import solve_flex
from ..layout.validate import compute_nesting_conflicts, parse_flex_response, validate_flex_dsl
from ..ops.contact_sheet import build_labeled_contact_sheet
from ..vlm.client import encode_pil_b64_png, get_api_client
from ..vlm.personas import (
    build_critic_messages,
    build_planner_messages,
    build_refiner_messages,
    object_summary_lines,
)
from .artifacts import (
    copy_file,
    iteration_dirs,
    latest_iteration,
    purge_run_dir,
    record_failed_output,
    save_overlay_debug,
    write_json,
    write_text,
)
from .engine import ComposeEngine


class PipelineError(RuntimeError):
    pass


def _b64_file(path) -> str:
    try:
        with open(path, "rb") as f:
            return base64.b64encode(f.read()).decode("utf-8")
    except Exception:
        return ""


def _chat(client, messages, temperature: float, tag: str) -> Tuple[Dict, str]:
    """One VLM round-trip with the reference's error-sentinel semantics."""
    try:
        response = client.chat_completion(messages=messages, temperature=temperature)
        raw_text = response.get("message", {}).get("content", "")
        return parse_flex_response(raw_text), raw_text
    except Exception as e:  # noqa: BLE001 - sentinel contract
        print(f"[{tag}] VLM API error: {e}")
        return {"error": "api_error", "detail": str(e)}, ""


def run_macro_only(
    output_dir: Path,
    ratio: str,
    align: str,
    margin: float,
    api_type: str = "auto",
    samples: int = 1,
    temperature: float = 1.0,
    refine_iters: int = 10,
    original_input_path: Optional[str] = None,
    api_key: Optional[str] = None,
    planner_addendum: str = "",
    refiner_addendum: str = "",
    planner_custom_design_rules: Optional[str] = None,
    critic_custom_design_rules: Optional[str] = None,
    refiner_custom_design_rules: Optional[str] = None,
    base_output_root: Optional[Path] = None,
    resume: bool = False,
    background: str = "solid",
    device="cuda",
) -> Path:
    """Run the full macro-placement loop for one bundle on ``device``
    ("cuda", "cpu" or a torch.device; CUDA without a card raises).
    Returns the run dir."""
    device = resolve_device(str(device))
    print("\n=== Running macro placement with Flex DSL and iterative refinement ===")
    output_dir = Path(output_dir)
    bundle = load_bundle(output_dir)
    # Validate the ratio BEFORE any purge so a bad invocation cannot destroy
    # a previous run's artifacts (the reference purges first —
    # macro_placement_test.py:1381 — which loses resumable state).
    from ..layout.canvas import parse_ratio as _parse_ratio

    _parse_ratio(ratio)
    if background not in ("solid", "gradient"):
        raise PipelineError(f"unknown background mode: {background!r}")
    root_out = Path(base_output_root) if base_output_root else Path.cwd() / "output_macro_placement"
    base_out = root_out / output_dir.name

    start_iter = 0
    flex_raw: Dict = {}
    previous_critic_text = ""
    previous_refiner_json: Optional[Dict] = None
    resume_state = None
    if resume:
        # Scan BACKWARD for the newest iteration that finished (has
        # loop_state.json): a crash mid-iteration leaves the latest dir
        # half-built, and resuming from it would otherwise fall through to
        # the purge and destroy every completed iteration.
        last = latest_iteration(base_out)
        while last is not None and last >= 0:
            state_path = (
                base_out / f"iteration_{last:02d}" / "layout_json"
                / "loop_state.json"
            )
            if state_path.exists():
                resume_state = json.loads(state_path.read_text())
                flex_raw = resume_state["flex_raw"]
                previous_critic_text = resume_state.get(
                    "previous_critic_text", ""
                )
                previous_refiner_json = resume_state.get("previous_refiner_json")
                start_iter = last + 1
                print(f"[resume] continuing from iteration {start_iter}")
                break
            last -= 1
    if start_iter == 0:
        purge_run_dir(base_out)

    timer = StepTimer()
    logger = RunLogger(base_out / "events.jsonl")
    client = get_api_client(api_type, api_key=api_key)

    with timer.time_step("prepare"):
        # First device contact happens HERE, deliberately: CUDA context
        # creation and the first host->device transfer are paid in
        # "prepare", not by whichever later step touches the device first.
        if device.type == "cuda":
            torch.cuda.init()
        torch.zeros((1,), dtype=torch.uint8).to(device).cpu()
        ow, oh = bundle.background.size
        canvas_size = compute_canvas_size((ow, oh), ratio)
        sizes = bundle.sizes()
        required_ids = bundle.object_ids()
        id_to_label = bundle.id_to_label()
        labels = [id_to_label[oid] or f"id_{oid}" for oid in required_ids]
        dims = [sizes[oid] for oid in required_ids]
        row_bad, col_bad = compute_nesting_conflicts(labels, dims, canvas_size, margin)
        # Quirk parity: bbox normalization against the canvas size (see
        # module docstring).
        summary_lines, role_lines = object_summary_lines(bundle.items, canvas_size)
        summary_text = "\n".join(summary_lines)
        meta = {
            "ratio": ratio,
            "align": align,
            "margin": margin,
            "api": api_type,
            "canvas_size": {"width": canvas_size[0], "height": canvas_size[1]},
            "original_image": {"width": ow, "height": oh},
            "samples": samples,
            "temperature": temperature,
            "refine_iters": refine_iters,
            "background": background,
        }

    with timer.time_step("contact_sheet"):
        sheet = build_labeled_contact_sheet(
            bundle.objects, id_to_label, device=device
        )

    # Background canvas, synthesized on the device. "solid" is the
    # reference's only mode (run_macro_only always calls fill_solid);
    # "gradient" exposes the reference's API-complete-but-uncalled
    # fill_gradient (reference/background_resizing.py:63-98) as an option.
    from ..ops.background import synthesize_canvas

    canvas_dev = synthesize_canvas(
        torch.from_numpy(np.asarray(bundle.background).copy()).to(device),
        canvas_size[0], canvas_size[1], background,
    )
    canvas_np = canvas_dev.cpu().numpy()
    canvas_img = Image.fromarray(canvas_np, "RGBA")

    arrays = bundle.to_arrays()
    engine = ComposeEngine(arrays, canvas_dev, device)

    d0 = iteration_dirs(base_out, 0)
    canvas_path_0 = d0.in_image / "canvas.png"
    contact_b64 = encode_pil_b64_png(sheet)
    original_b64 = _b64_file(original_input_path) if original_input_path else ""

    def save_composed(dirs, placements: List[Dict], iter_idx: int, method: str) -> Path:
        final_json = {
            "canvas": {
                "width": canvas_size[0], "height": canvas_size[1],
                "margin": margin, "align": align,
            },
            "placements": [
                {**p, "name": id_to_label.get(int(p["object_id"]), str(int(p["object_id"])))}
                for p in placements
            ],
        }
        write_json(dirs.layout / f"layout_macro_iter_{iter_idx:02d}.json", final_json)
        draft_dev = engine.compose(final_json["placements"])
        draft_path = dirs.final / f"draft_macro_iter_{iter_idx:02d}.png"
        from ..core.native_io import save_png

        save_png(draft_dev.cpu().numpy(), draft_path)
        save_overlay_debug(
            final_json["placements"], canvas_size,
            dirs.final / f"overlay_debug_iter_{iter_idx:02d}.png",
        )
        write_json(
            dirs.layout / f"provenance_iter_{iter_idx:02d}.json",
            {"method": method, "fallback": False, "iteration": iter_idx},
        )
        return draft_path

    def save_loop_state(dirs) -> None:
        write_json(dirs.layout / "loop_state.json", {
            "flex_raw": flex_raw,
            "previous_critic_text": previous_critic_text,
            "previous_refiner_json": previous_refiner_json,
            "best_practices": best_practices,
        })

    def validate(data: Dict, *, baseline: bool) -> None:
        kwargs = dict(
            row_bad_pairs={frozenset({a, b}) for a, b in row_bad},
            col_bad_pairs={frozenset({a, b}) for a, b in col_bad},
            forbid_root_spacing=True,
        )
        if baseline:
            kwargs.update(
                allow_container_spacing=False, allow_container_align=False,
                drop_container_styling=True, sanitize=True,
            )
        else:
            kwargs.update(
                allow_object_tuning=True, allow_container_spacing=True,
                allow_container_align=True,
            )
        validate_flex_dsl(data, required_ids, id_to_label, **kwargs)

    draft_path_prev: Optional[Path] = None
    best_practices = ""

    if start_iter == 0:
        # ----------------------- iteration_00: baseline -----------------------
        write_json(d0.in_text / "run_metadata.json", meta)
        sheet.save(d0.in_image / "contact_sheet.png")
        copy_file(bundle.background_path, d0.in_image / "background.png")
        canvas_img.save(canvas_path_0)
        if original_input_path:
            copy_file(original_input_path, d0.in_image / Path(original_input_path).name)

        with timer.time_step("vlm_flex_baseline"):
            canvas_b64 = _b64_file(canvas_path_0)
            images = [contact_b64, canvas_b64] + ([original_b64] if original_b64 else [])
            messages, prompt_text, best_practices = build_planner_messages(
                ratio=ratio,
                summary_text=summary_text,
                role_lines=role_lines,
                row_bad=row_bad,
                col_bad=col_bad,
                images_b64=images,
                planner_addendum=planner_addendum,
                custom_design_rules=planner_custom_design_rules,
            )
            flex_raw, raw_text = _chat(client, messages, temperature, "flex")
            write_json(d0.vlm_out / "layout_flex_iter_00.json", flex_raw)
            write_text(d0.vlm_out / "vlm_raw_iter_00.txt", raw_text)
            write_text(d0.in_text / "prompt_flex.txt", prompt_text)
            write_text(d0.in_text / "best_practices.txt", best_practices)

            try:
                validate(flex_raw, baseline=True)
            except Exception as e:  # persist + continue (ref behavior)
                logger.log("validate", f"Baseline layout failed validation: {e}", iteration=0)
                write_text(d0.in_text / "flex_validation_error_iter_00.txt", str(e))
                record_failed_output(d0.vlm_out / "failed_output.txt", str(e), flex_raw)

        with timer.time_step("compose_baseline"):
            if "root" not in flex_raw:
                raise PipelineError(
                    f"planner produced no usable layout: {flex_raw.get('error', flex_raw)}"
                )
            placements = solve_flex(flex_raw["root"], canvas_size, sizes)
            draft_path_prev = save_composed(d0, placements, 0, "flex")
        save_loop_state(d0)
    else:
        d_prev = iteration_dirs(base_out, start_iter - 1)
        # The newest iteration may have skipped compose (identical-JSON or
        # no-root): walk back to the newest draft that actually exists so
        # the critic/refiner see a real image, not an empty b64 payload.
        draft_path_prev = (
            d_prev.final / f"draft_macro_iter_{start_iter - 1:02d}.png"
        )
        for j in range(start_iter - 1, -1, -1):
            cand = (
                iteration_dirs(base_out, j).final
                / f"draft_macro_iter_{j:02d}.png"
            )
            if cand.exists():
                draft_path_prev = cand
                break
        canvas_path_0 = d_prev.in_image / "canvas.png"
        if not canvas_path_0.exists():
            canvas_path_0 = iteration_dirs(base_out, 0).in_image / "canvas.png"
        # restore the run's ACTUAL best-practices text (it may have been
        # planner_custom_design_rules); older loop states fall back to the
        # ratio-family default
        bp_saved = (resume_state or {}).get("best_practices")
        if bp_saved:
            best_practices = bp_saved
        else:
            from ..vlm.personas import best_practices_text as _bp
            from ..layout.canvas import ratio_family as _rf

            best_practices = _bp(_rf(ratio))
        # keep the timing record of pre-resume steps: the final write
        # replaces time_log.txt wholesale
        timer.load_from_file(base_out / "time_log.txt")

    # --------------------------- refinement loop ---------------------------
    for i in range(max(1, start_iter), max(0, refine_iters) + 1):
        di = iteration_dirs(base_out, i)
        copy_file(draft_path_prev, di.in_image / "composite_prev.png")
        copy_file(bundle.background_path, di.in_image / "background.png")
        copy_file(canvas_path_0, di.in_image / "canvas.png")

        with timer.time_step(f"vlm_critic_iter_{i:02d}"):
            critic_images = [contact_b64]
            crit_orig = original_b64 or _b64_file(bundle.background_path)
            if crit_orig:
                critic_images.append(crit_orig)
            composite_b64 = _b64_file(draft_path_prev)
            if composite_b64:
                critic_images.append(composite_b64)
            critic_messages, critic_prompt = build_critic_messages(
                ratio=ratio,
                summary_text=summary_text,
                role_lines=role_lines,
                row_bad=row_bad,
                col_bad=col_bad,
                images_b64=critic_images,
                best_practices=best_practices,
                previous_critic_text=previous_critic_text,
                previous_refiner_json=previous_refiner_json,
                custom_design_rules=critic_custom_design_rules,
            )
            try:
                critic_raw = client.chat_completion(
                    messages=critic_messages, temperature=0.3
                ).get("message", {}).get("content", "")
            except Exception as e:  # noqa: BLE001
                print(f"[critic] VLM API error: {e}")
                critic_raw = f"[critic_api_error] {e}"
            write_text(di.in_text / f"critic_prompt_iter_{i:02d}.txt", critic_prompt)
            write_text(di.vlm_out / f"critic_raw_iter_{i:02d}.txt", critic_raw)

        with timer.time_step(f"vlm_refine_iter_{i:02d}"):
            refine_images = [contact_b64, _b64_file(canvas_path_0)]
            if original_b64:
                refine_images.append(original_b64)
            prev_draft_b64 = _b64_file(draft_path_prev)
            if prev_draft_b64:  # missing draft: send no empty payload
                refine_images.append(prev_draft_b64)

            def request_refine(extra_instr: str):
                msgs, prompt = build_refiner_messages(
                    ratio=ratio,
                    summary_text=summary_text,
                    role_lines=role_lines,
                    row_bad=row_bad,
                    col_bad=col_bad,
                    images_b64=refine_images,
                    prev_flex_json=flex_raw,
                    critic_text=critic_raw,
                    extra_instructions=extra_instr,
                    refiner_addendum=refiner_addendum,
                    custom_design_rules=refiner_custom_design_rules,
                )
                data, raw = _chat(client, msgs, temperature, "refine")
                return data, prompt, raw

            refine_raw, refine_prompt, refine_raw_text = request_refine("")
            write_json(di.vlm_out / f"layout_flex_iter_{i:02d}.json", refine_raw)
            write_text(di.vlm_out / f"vlm_raw_iter_{i:02d}.txt", refine_raw_text)
            write_text(di.in_text / f"prompt_refine_iter_{i:02d}.txt", refine_prompt)

            try:
                validate(refine_raw, baseline=False)
            except Exception as e:  # retry once with validator feedback
                logger.log("validate", f"Iter {i:02d} refine failed validation: {e}", iteration=i)
                write_text(di.in_text / f"flex_validation_error_iter_{i:02d}.txt", str(e))
                record_failed_output(
                    di.vlm_out / f"failed_output_iter_{i:02d}.txt", str(e), refine_raw
                )
                refine_raw, refine_prompt, refine_raw_text = request_refine(str(e))
                write_json(di.vlm_out / f"layout_flex_iter_{i:02d}_retry.json", refine_raw)
                write_text(di.vlm_out / f"vlm_raw_iter_{i:02d}_retry.txt", refine_raw_text)
                write_text(di.in_text / f"prompt_refine_iter_{i:02d}_retry.txt", refine_prompt)
                try:
                    validate(refine_raw, baseline=False)
                except Exception as e2:  # keep artifacts, move on
                    logger.log("validate", f"Iter {i:02d} refine retry failed validation: {e2}", iteration=i, retry=True)
                    write_text(
                        di.in_text / f"flex_validation_error_iter_{i:02d}_retry.txt",
                        str(e2),
                    )
                    record_failed_output(
                        di.vlm_out / f"failed_output_iter_{i:02d}_retry.txt",
                        str(e2),
                        refine_raw,
                    )

            # Identical JSON => no structural change; skip composing (and, as
            # in the reference, leave the carried loop state untouched).
            if json.dumps(flex_raw, sort_keys=True) == json.dumps(refine_raw, sort_keys=True):
                logger.log("refine", f"Iter {i:02d} produced identical JSON; skipping compose.", iteration=i, no_change=True)
                write_text(
                    di.in_text / f"no_change_iter_{i:02d}.txt",
                    "Refined JSON identical to previous; aborting.",
                )
                save_loop_state(di)
                continue

        with timer.time_step(f"compose_iter_{i:02d}"):
            if "root" not in refine_raw:
                logger.log("compose", f"Iter {i:02d} has no usable layout; skipping compose.", iteration=i)
                save_loop_state(di)
                continue
            try:
                placements_i = solve_flex(refine_raw["root"], canvas_size, sizes)
            except Exception as e:  # noqa: BLE001 - robustness extension:
                # a document that failed validation twice can still reach
                # here structurally broken; the reference would crash the
                # whole run (losing the remaining iterations), we persist
                # the failure and move on like the validation path does
                logger.log("compose", f"Iter {i:02d} solve failed: {e}", iteration=i)
                record_failed_output(
                    di.vlm_out / f"failed_output_iter_{i:02d}.txt", str(e),
                    refine_raw,
                )
                save_loop_state(di)
                continue
            draft_path_prev = save_composed(di, placements_i, i, "flex_refine")

        flex_raw = refine_raw
        previous_refiner_json = refine_raw
        previous_critic_text = critic_raw
        save_loop_state(di)

    timer.write_to_file(str(base_out / "time_log.txt"))
    print(f"Macro outputs (with refinements) saved to: {base_out}")
    return base_out
