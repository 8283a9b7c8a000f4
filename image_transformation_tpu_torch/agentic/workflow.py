# Copy of image_transformation_tpu/agentic/workflow.py (host-only), plus the run's device.
"""Agentic workflow wiring: state init + graph construction + runner.

Graph parity: the reference's agentic/graph.py:19-47 and workflow.py:16-67
(macro -> validator -> compositor -> critic -(stop?)-> micro -> validator
cycle, stop when should_stop or iteration >= max_iterations).

``device`` (default "cuda"; raises without a card) is where the
compositor node composes: K1 on a card, its plain version on the CPU.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

from PIL import Image

from .graph import END, StateGraph
from .nodes import (
    build_compositor_node,
    build_critic_node,
    build_macro_node,
    build_micro_node,
    build_validator_node,
)
from .state import AgentState, ObjectMeta, RunContext


def load_objects(results_json_path: Path, objects_dir: Path) -> Dict[int, ObjectMeta]:
    """ObjectMeta map from the shared bundle loader (one metadata parse,
    one image-open per object — previously a parallel re-implementation
    that opened every PNG a second time). ``objects_dir`` is part of the
    reference signature; the bundle layout fixes it to results.json's
    sibling ``objects/``."""
    del objects_dir  # reference-signature parity; derived from the bundle
    from ..core.bundle import load_bundle

    bundle = load_bundle(Path(results_json_path).parent)
    objects: Dict[int, ObjectMeta] = {}
    for oid, m in bundle.meta.items():
        name = (m.label or "").strip() or f"id_{oid}"
        objects[int(oid)] = ObjectMeta(
            int(oid), name, Path(m.filename).name, m.width, m.height
        )
    return objects


def initialize_state(
    image_name: str,
    ratio: str,
    bundle_dir: Path,
    base_run_dir: Path,
    api_type: str,
    api_key: Optional[str],
    temperature: float,
    max_iterations: int,
    canvas_size: Tuple[int, int],
    original_image_path: Optional[Path] = None,
    device: str = "cuda",
) -> AgentState:
    from ..core.bundle import ensure_bundle
    from ..core.device import resolve_device

    device = str(resolve_device(str(device)))

    bundle_dir = ensure_bundle(bundle_dir)
    objects = load_objects(bundle_dir / "results.json", bundle_dir / "objects")
    run_root = Path(base_run_dir) / image_name
    run_root.mkdir(parents=True, exist_ok=True)
    run = RunContext(
        image_name=image_name,
        ratio=ratio,
        canvas_size=canvas_size,
        bundle_dir=bundle_dir,
        background_path=bundle_dir / "background.png",
        objects_dir=bundle_dir / "objects",
        results_json_path=bundle_dir / "results.json",
        original_image_path=original_image_path,
        run_root=run_root,
        max_iterations=max_iterations,
    )
    return AgentState(
        run=run,
        objects=objects,
        api_type=api_type,
        api_key=api_key,
        temperature=temperature,
        max_iterations=max_iterations,
        device=device,
    )


def build_workflow(model_macro, model_micro, model_critic, objects) -> StateGraph:
    graph = StateGraph(AgentState)
    graph.add_node("macro", build_macro_node(model_macro))
    graph.add_node("micro", build_micro_node(model_micro))
    graph.add_node("critic", build_critic_node(model_critic))
    graph.add_node("validator", build_validator_node(list(objects)))
    graph.add_node("compositor", build_compositor_node())

    graph.set_entry_point("macro")
    graph.add_edge("macro", "validator")
    graph.add_edge("validator", "compositor")
    graph.add_edge("compositor", "critic")
    graph.add_conditional_edges(
        "critic",
        lambda s: "STOP" if s.should_stop or s.iteration >= s.max_iterations else "CONTINUE",
        {"STOP": END, "CONTINUE": "micro"},
    )
    graph.add_edge("micro", "validator")
    return graph


def run_workflow(
    bundle_dir: Path,
    ratio: str,
    base_run_dir: Path,
    api_type: str = "auto",
    api_key: Optional[str] = None,
    temperature: float = 0.7,
    max_iterations: int = 2,
    device: str = "cuda",
) -> AgentState:
    """Convenience runner: three persona models (micro slightly cooler,
    critic at 0.2, as the reference UI configures), compile, invoke. The
    compositor runs on ``device``."""
    from ..layout.canvas import compute_canvas_size
    from .models import create_chat_model

    bundle_dir = Path(bundle_dir)
    with Image.open(bundle_dir / "background.png") as im:
        canvas_size = compute_canvas_size(im.size, ratio, verbose=False)
    state = initialize_state(
        image_name=bundle_dir.name,
        ratio=ratio,
        bundle_dir=bundle_dir,
        base_run_dir=base_run_dir,
        api_type=api_type,
        api_key=api_key,
        temperature=temperature,
        max_iterations=max_iterations,
        canvas_size=canvas_size,
        device=device,
    )
    macro = create_chat_model(api_type, api_key, temperature)
    micro = create_chat_model(api_type, api_key, max(0.0, temperature - 0.1))
    critic = create_chat_model(api_type, api_key, 0.2)
    app = build_workflow(macro, micro, critic, state.objects).compile()
    return app.invoke(state)
