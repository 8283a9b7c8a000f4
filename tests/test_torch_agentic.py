"""The port's agentic graph (image_transformation_tpu_torch.agentic) on the
CPU: the cases of tests/test_agentic.py against the port's modules, and a
parity run against the JAX package's workflow under one FakeClient script:
byte-equal drafts and equal layout JSON at every iteration.
"""

import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from image_transformation_tpu.agentic.workflow import run_workflow as jax_run_workflow
from image_transformation_tpu.vlm.client import FakeClient as JaxFakeClient
from image_transformation_tpu.vlm.client import register_fake_client as jax_register
from image_transformation_tpu_torch.agentic.graph import END, StateGraph
from image_transformation_tpu_torch.agentic.state import ObjectMeta
from image_transformation_tpu_torch.agentic.tools import placements_from_flex
from image_transformation_tpu_torch.agentic.workflow import run_workflow
from image_transformation_tpu_torch.vlm.client import FakeClient, register_fake_client

LAYOUT = {
    "root": {
        "type": "flex",
        "direction": "column",
        "gap_px": 4,
        "children": [
            {"object_id": 1, "name": "logo"},
            {"object_id": 2, "name": "photo"},
            {"object_id": 3, "name": "text"},
            {"object_id": 4, "name": "cta"},
        ],
    }
}
SCRIPT = [
    json.dumps(LAYOUT),  # macro
    "Score: 7/10\nSuggestions: move logo right",  # critic round 1
    {  # micro: actual tool calls
        "message": {
            "content": "",
            "tool_calls": [
                {"id": "c1", "function": {"name": "adjust_x",
                                          "arguments": json.dumps({"object": "logo", "pixels": 10})}},
                {"id": "c2", "function": {"name": "adjust_y",
                                          "arguments": json.dumps({"object": "4", "pixels": -5})}},
            ],
        }
    },
    "Score: 6/10\nSuggestions: nudge the text",  # critic round 2
    {
        "message": {
            "content": "",
            "tool_calls": [
                {"id": "c3", "function": {"name": "adjust_x",
                                          "arguments": json.dumps({"object": "text", "pixels": 25})}},
            ],
        }
    },
    "Score: 9/10\nLooks good.",  # critic round 3 (stops on the iteration cap)
]


def teardown_module(module):
    register_fake_client(None)
    jax_register(None)


def _draft(root: Path, it: int) -> np.ndarray:
    return np.asarray(Image.open(
        root / "squarespace" / f"iteration_{it:02d}" / "final_product"
        / f"draft_macro_iter_{it:02d}.png"))


def _layout_json(root: Path, it: int) -> str:
    return (root / "squarespace" / f"iteration_{it:02d}" / "layout_json"
            / f"layout_macro_iter_{it:02d}.json").read_text()


def test_graph_engine_runs_and_routes():
    g = StateGraph(dict)
    trace = []
    g.add_node("a", lambda s: (trace.append("a"), s)[1])
    g.add_node("b", lambda s: (trace.append("b"), s.update(n=s.get("n", 0) + 1) or s)[1])
    g.set_entry_point("a")
    g.add_edge("a", "b")
    g.add_conditional_edges(
        "b", lambda s: "STOP" if s["n"] >= 3 else "LOOP", {"STOP": END, "LOOP": "b"}
    )
    out = g.compile().invoke({})
    assert out["n"] == 3
    assert trace == ["a", "b", "b", "b"]


def test_simplified_solver_packs_top_left():
    objects = {
        1: ObjectMeta(1, "a", "a.png", 100, 40),
        2: ObjectMeta(2, "b", "b.png", 60, 30),
    }
    flex = {"root": {"type": "flex", "direction": "column", "gap_px": 5,
                     "children": [{"object_id": 1}, {"object_id": 2}]}}
    placements = placements_from_flex(flex, (200, 200), objects)
    assert placements[1].box == [0, 0, 100, 40]
    assert placements[2].box == [0, 45, 60, 75]


def test_simplified_solver_rejects_overflow_and_missing():
    objects = {1: ObjectMeta(1, "a", "a.png", 300, 40)}
    flex = {"root": {"type": "flex", "direction": "row", "children": [{"object_id": 1}]}}
    with pytest.raises(ValueError, match="larger than canvas"):
        placements_from_flex(flex, (200, 200), objects)
    objects[2] = ObjectMeta(2, "b", "b.png", 10, 10)
    with pytest.raises(ValueError, match="missing required"):
        placements_from_flex(flex, (400, 200), objects)


def test_agentic_end_to_end_with_tool_calls(tmp_path):
    register_fake_client(lambda: FakeClient(SCRIPT[:4]))
    try:
        state = run_workflow(bundle_dir="data/squarespace", ratio="9:16", base_run_dir=tmp_path,
                             api_type="auto", max_iterations=1, device="cpu")
    finally:
        register_fake_client(None)
    assert state.device == "cpu"
    assert state.iteration == 1
    assert len(state.last_tool_calls) == 2
    logo = state.placements[1]
    assert logo.x == 10 and logo.y == 0
    cta = state.placements[4]
    assert cta.y == sum(m.height for m in list(state.objects.values())[:3]) + 3 * 4 - 5
    img0, img1 = _draft(tmp_path, 0), _draft(tmp_path, 1)
    assert img1.shape == (657, 369, 4)
    assert not np.array_equal(img1, img0)  # the logo moved


def test_agentic_run_equals_jax_run(tmp_path):
    """Same script, same bundle: the port's drafts are byte-equal to JAX's
    and to PIL's own compose of the layout, and the layout JSON is equal,
    at every iteration."""
    register_fake_client(lambda: FakeClient(SCRIPT))
    try:
        run_workflow("data/squarespace", "9:16", tmp_path / "port", max_iterations=2,
                     device="cpu")
    finally:
        register_fake_client(None)
    jax_register(lambda: JaxFakeClient(SCRIPT))
    try:
        jax_run_workflow("data/squarespace", "9:16", tmp_path / "jax", max_iterations=2)
    finally:
        jax_register(None)
    from image_transformation_tpu_torch.core.bundle import load_bundle

    bundle = load_bundle("data/squarespace")
    median = tuple(int(v) for v in np.median(
        np.asarray(bundle.background)[np.asarray(bundle.background)[..., 3] > 0][:, :3],
        axis=0))
    for it in range(3):
        got, want = _draft(tmp_path / "port", it), _draft(tmp_path / "jax", it)
        assert np.array_equal(got, want), it
        layout = _layout_json(tmp_path / "port", it)
        assert layout == _layout_json(tmp_path / "jax", it)
        pil = Image.new("RGBA", (369, 657), (*median, 255))
        for p in json.loads(layout)["placements"]:
            pil.alpha_composite(bundle.objects[p["object_id"]], dest=tuple(p["box"][:2]))
        assert np.array_equal(got, np.asarray(pil)), it


def test_agentic_compositor_rejects_scaling(tmp_path):
    from image_transformation_tpu_torch.agentic.nodes import build_compositor_node
    from image_transformation_tpu_torch.agentic.state import PlacementState
    from image_transformation_tpu_torch.agentic.workflow import initialize_state

    state = initialize_state(
        image_name="squarespace", ratio="9:16", bundle_dir=Path("data/squarespace"),
        base_run_dir=tmp_path, api_type="auto", api_key=None, temperature=0.5,
        max_iterations=1, canvas_size=(369, 657), device="cpu",
    )
    meta = state.objects[1]
    state.register_placement(PlacementState(1, meta.name, 0, 0, meta.width // 2, meta.height))
    with pytest.raises(ValueError, match="scaling objects is not permitted"):
        build_compositor_node()(state)


def test_initialize_state_defaults_to_cuda(tmp_path):
    import torch

    from image_transformation_tpu_torch.agentic.workflow import initialize_state

    kwargs = dict(image_name="squarespace", ratio="9:16", bundle_dir=Path("data/squarespace"),
                  base_run_dir=tmp_path, api_type="auto", api_key=None, temperature=0.5,
                  max_iterations=1, canvas_size=(369, 657))
    if torch.cuda.is_available():
        assert initialize_state(**kwargs).device.startswith("cuda")
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            initialize_state(**kwargs)


def test_extract_json_object_survives_prose_and_fences():
    from image_transformation_tpu_torch.agentic.nodes import extract_json_object

    layout = {"root": {"type": "flex", "children": [{"object_id": 1}]}}
    blob = json.dumps(layout)
    cases = [
        blob,
        f"Here is the layout: {blob} Note: tune {{gap_px}} later.",
        f"Sure!\n```json\n{blob}\n```\nLet me know.",
        f"prose first\n```\n{blob}\n```",
        f"{{broken json}} then the real one {blob}",
    ]
    for text in cases:
        assert extract_json_object(text) == layout, text[:60]
    with pytest.raises(ValueError):
        extract_json_object("no json here {not: valid}")


def test_micro_nudges_clamp_on_canvas():
    from image_transformation_tpu_torch.agentic.state import (
        AgentState,
        PlacementState,
        RunContext,
    )
    from image_transformation_tpu_torch.agentic.tools import adjust_x, adjust_y

    run = RunContext(
        image_name="t", ratio="1:1", canvas_size=(100, 80), bundle_dir=".",
        background_path=".", objects_dir=".", results_json_path=".",
        original_image_path=None, run_root=".", max_iterations=1,
    )
    state = AgentState(
        run=run,
        objects={1: ObjectMeta(1, "logo", "logo.png", 30, 20)},
        api_type="fake", api_key=None, temperature=0.0,
    )
    state.placements["logo"] = PlacementState(
        object_id=1, name="logo", x=5, y=5, width=30, height=20
    )
    adjust_x(state, "logo", -50)
    assert state.placements["logo"].x == 0
    adjust_y(state, "logo", 500)
    assert state.placements["logo"].y == 60  # 80 - 20
    adjust_x(state, "logo", 500)
    assert state.placements["logo"].x == 70  # 100 - 30
