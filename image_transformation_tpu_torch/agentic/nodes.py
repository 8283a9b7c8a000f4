# Copy of image_transformation_tpu/agentic/nodes.py (host nodes copied; the compositor ported to torch).
"""Agentic graph nodes: macro, micro, critic, validator, compositor.

Parity anchors: the reference's agentic/nodes/*.py. Differences:
- the micro node's tool loop actually executes (working tool-calling);
- the compositor renders on the run's device (``state.device``):
  ``ops.background.masked_median_rgb`` and ``solid_canvas`` there, then
  ``ops.compose.composite_exact``, which is K1 on a CUDA device and its
  plain version on the CPU (identity-size pastes; any size mismatch still
  raises — scaling is forbidden in this pipeline, as in the reference
  compositor).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch
from PIL import Image

from ..core.device import resolve_device
from .state import AgentState
from .tools import (
    MACRO_TOOL_REGISTRY,
    MICRO_TOOL_DEFINITIONS,
    MICRO_TOOL_REGISTRY,
)

_PROMPT_DIR = Path(__file__).parent / "prompts"


def load_prompt(name: str) -> str:
    return (_PROMPT_DIR / f"{name}.txt").read_text(encoding="utf-8")


def extract_json_object(text: str) -> Dict:
    """Tolerant JSON extraction; raises ValueError when nothing parses.
    One extractor for the whole framework: vlm.client.scan_json_object
    (fence-aware balanced-brace scan)."""
    from ..vlm.client import scan_json_object

    obj = scan_json_object(text)
    if obj is None:
        raise ValueError("no JSON object found in response")
    return obj


def _iteration_dirs(state: AgentState) -> Dict[str, Path]:
    root = state.iteration_dir
    dirs = {
        "final_product": root / "final_product",
        "vlm_input_text": root / "vlm_input_text",
        "vlm_output": root / "vlm_output",
        "layout_json": root / "layout_json",
    }
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    return dirs


def _write(path: Path, text: str) -> None:
    path.write_text(text, encoding="utf-8")


def _object_summary(state: AgentState) -> str:
    return "\n".join(
        f"- {m.object_id}: {m.name} ({m.width}x{m.height})"
        for m in state.objects.values()
    )


def build_macro_node(model) -> Callable[[AgentState], AgentState]:
    template = load_prompt("macro_layouter")

    def node(state: AgentState) -> AgentState:
        state.iteration = 0
        state.should_stop = False
        prompt = (
            template.replace("{{OBJECT_SUMMARY}}", _object_summary(state))
            .replace("{{CANVAS_WIDTH}}", str(state.canvas_size[0]))
            .replace("{{CANVAS_HEIGHT}}", str(state.canvas_size[1]))
            .replace("{{RATIO}}", state.ratio)
        )
        response = model.invoke({"messages": state.messages + [{"role": "system", "content": prompt}]})
        text = getattr(response, "content", str(response))
        state.messages.append({"role": "assistant", "content": text})
        state.last_macro_text = text

        dirs = _iteration_dirs(state)
        _write(dirs["vlm_input_text"] / f"planner_prompt_iter_{state.iteration:02d}.txt", prompt)
        _write(dirs["vlm_output"] / f"vlm_raw_iter_{state.iteration:02d}.txt", text)
        try:
            obj = extract_json_object(text)
        except ValueError as exc:
            _write(
                dirs["vlm_output"] / f"failed_output_iter_{state.iteration:02d}.txt",
                f"Parse error: {exc}\n\nRAW OUTPUT:\n{text}",
            )
            raise ValueError("Macro layouter must return JSON") from exc
        root = obj.get("root") if isinstance(obj, dict) else None
        if root is None and isinstance(obj, dict) and obj.get("type") == "flex" and "children" in obj:
            root = obj  # accept a bare flex container
        if root is None:
            _write(
                dirs["vlm_output"] / f"failed_output_iter_{state.iteration:02d}.txt",
                "Missing root container.\n\nExtracted JSON:\n" + json.dumps(obj, indent=2),
            )
            raise ValueError("Flex JSON must include a root container or be a single flex container")
        with open(dirs["vlm_output"] / f"layout_flex_iter_{state.iteration:02d}.json", "w") as f:
            json.dump({"root": root}, f, indent=2)
        MACRO_TOOL_REGISTRY["set_flex_json"](state, root, text)
        state.phase = "macro"
        return state

    return node


def _format_placements(state: AgentState) -> str:
    if not state.placements:
        return "No placements available yet."
    return "\n".join(
        f"- {p.name} (id={p.object_id}) @ ({p.x}, {p.y}) size={p.width}x{p.height}"
        for p in sorted(state.placements.values(), key=lambda p: p.object_id)
    )


def build_micro_node(model) -> Callable[[AgentState], AgentState]:
    template = load_prompt("micro_layouter")

    def node(state: AgentState) -> AgentState:
        feedback = state.critic_notes[-1] if state.critic_notes else (
            state.last_critic_text or "No critic feedback provided."
        )
        prompt = (
            template.replace("{{CURRENT_PLACEMENTS}}", _format_placements(state))
            .replace("{{CRITIC_FEEDBACK}}", feedback)
        )
        response = model.invoke({
            "messages": state.messages + [{"role": "system", "content": prompt}],
            "tools": MICRO_TOOL_DEFINITIONS,
            "tool_choice": "auto",
        })
        text = getattr(response, "content", "") or ""
        executed: List[Dict] = []
        for call in getattr(response, "tool_calls", []) or []:
            fn = call.get("function", {})
            name = fn.get("name")
            if not name:
                continue
            tool = MICRO_TOOL_REGISTRY.get(name)
            if tool is None:
                raise ValueError(f"Unknown tool '{name}' requested by micro layouter")
            raw_args = fn.get("arguments", "") or "{}"
            try:
                args = json.loads(raw_args) if isinstance(raw_args, str) else dict(raw_args)
            except json.JSONDecodeError as exc:
                raise ValueError(f"Invalid JSON arguments for tool call: {raw_args}") from exc
            print(f"[micro] tool call {name}({args})")
            result = tool(state, **args)
            executed.append(
                {"id": call.get("id"), "tool": name, "arguments": args, "result": result}
            )
        state.last_tool_calls = executed
        state.messages.append({"role": "assistant", "content": text})
        state.last_micro_text = text
        state.phase = "micro"
        state.iteration += 1
        return state

    return node


def build_critic_node(model) -> Callable[[AgentState], AgentState]:
    template = load_prompt("critic")

    def node(state: AgentState) -> AgentState:
        lines = [
            f"Canvas: {state.canvas_size[0]}x{state.canvas_size[1]} (ratio {state.ratio})"
        ]
        if state.placements:
            lines.append("Placements:")
            lines += [
                f"- {p.name} (id={p.object_id}) box={p.box}"
                for p in state.placements.values()
            ]
        else:
            lines.append("Placements: none")
        prompt = template.replace("{{CONTEXT}}", "\n".join(lines))
        response = model.invoke({"messages": state.messages + [{"role": "system", "content": prompt}]})
        text = getattr(response, "content", str(response))
        state.last_critic_text = text
        state.critic_notes.append(text)
        state.messages.append({"role": "assistant", "content": text})
        state.phase = "critique"
        return state

    return node


def build_validator_node(required_ids: List[int]) -> Callable[[AgentState], AgentState]:
    def node(state: AgentState) -> AgentState:
        missing = [oid for oid in required_ids if oid not in state.placements]
        if missing:
            state.validation_errors.append(f"Missing placements for object ids: {missing}")
            raise ValueError("Coverage validation failed")
        state.phase = "validated"
        return state

    return node


_BUNDLE_ASSETS_CACHE: Dict[tuple, tuple] = {}


def _bundle_assets(bundle_dir, device):
    """(bundle, arrays, objects on the device, median) memoized per
    (bundle_dir, device): the compositor runs every loop iteration, and
    nothing in the bundle changes within a run."""
    key = (str(bundle_dir), str(device))
    entry = _BUNDLE_ASSETS_CACHE.get(key)
    if entry is None:
        from ..core.bundle import load_bundle
        from ..ops.background import masked_median_rgb

        bundle = load_bundle(bundle_dir)
        arrays = bundle.to_arrays()
        objs = torch.from_numpy(arrays.objects).to(device)
        median = masked_median_rgb(
            torch.from_numpy(np.array(bundle.background, np.uint8)).to(device)
        )
        entry = (bundle, arrays, objs, median)
        if len(_BUNDLE_ASSETS_CACHE) >= 4:
            _BUNDLE_ASSETS_CACHE.pop(next(iter(_BUNDLE_ASSETS_CACHE)))
        _BUNDLE_ASSETS_CACHE[key] = entry
    return entry


def build_compositor_node() -> Callable[[AgentState], AgentState]:
    def node(state: AgentState) -> AgentState:
        from ..ops.background import solid_canvas
        from ..ops.compose import composite_exact

        device = resolve_device(str(state.device))
        bundle, arrays, objs_dev, median = _bundle_assets(state.run.bundle_dir, device)

        # No scaling: every placement must use the object's natural size.
        # Z-ORDER = placement insertion order (DSL traversal), exactly the
        # reference compositor's paint order — sorting by object_id would
        # visibly reorder overlapping objects after micro nudges.
        order = list(state.placements.values())
        for p in order:
            meta = state.objects[p.object_id]
            if (p.width, p.height) != (meta.width, meta.height):
                raise ValueError("Placement size mismatch; scaling objects is not permitted")

        w, h = state.canvas_size
        canvas = solid_canvas(median.to(torch.uint8), h, w)

        idxs = [arrays.index_of(p.object_id) for p in order]
        if idxs:
            sel = torch.tensor(idxs, dtype=torch.long, device=device)
            boxes = np.array([p.box for p in order], np.int32)
            canvas = composite_exact(canvas, objs_dev[sel], arrays.obj_hw[idxs], boxes)
        out = canvas.cpu().numpy()

        dirs = _iteration_dirs(state)
        out_path = dirs["final_product"] / f"draft_macro_iter_{state.iteration:02d}.png"
        Image.fromarray(out, "RGBA").save(out_path)
        state.current_composite_path = out_path
        with open(dirs["layout_json"] / f"layout_macro_iter_{state.iteration:02d}.json", "w") as f:
            json.dump(
                {
                    "placements": [
                        {
                            "object_id": p.object_id,
                            "name": p.name,
                            "box": p.box,
                        }
                        for p in order
                    ]
                },
                f,
                indent=2,
            )
        return state

    return node
