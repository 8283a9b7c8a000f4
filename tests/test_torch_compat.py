"""The reference surface on the port (``compat/``) against the root shims,
on the CPU: ``macro_placement_test``, ``utils.timing``, ``utils.labels``
and the ``agentic`` package and modules.

Every name a root shim defines or re-exports resolves in its twin; the
helpers equal the root's on both bundles (contact sheets and drafts byte
for byte, tolerance 0); and the twins import neither jax nor the JAX
package.
"""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import agentic as root_agentic
import macro_placement_test as root_mpt
import utils.labels as root_labels
import utils.timing as root_timing
from image_transformation_tpu.vlm.client import register_fake_client as jax_register
from image_transformation_tpu_torch.agentic import AgentState
from image_transformation_tpu_torch.compat import agentic as port_agentic
from image_transformation_tpu_torch.compat import macro_placement_test as port_mpt
from image_transformation_tpu_torch.compat.agentic import state as port_state
from image_transformation_tpu_torch.compat.utils import labels as port_labels
from image_transformation_tpu_torch.compat.utils import timing as port_timing
from image_transformation_tpu_torch.vlm.client import register_fake_client as port_register

ROOT = Path(__file__).resolve().parents[1]
BUNDLES = ("squarespace", "audio_book")
#: (root shim, its twin under compat/)
TWINS = [("macro_placement_test", "macro_placement_test"), ("utils.timing", "utils.timing"),
         ("utils.labels", "utils.labels"), ("agentic", "agentic")] + [
    (f"agentic.{m}", f"agentic.{m}")
    for m in ("graph", "models", "nodes", "state", "tools", "workflow")]
NEW_MODULES = [f"image_transformation_tpu_torch.compat.{twin}" for _, twin in TWINS] + [
    "image_transformation_tpu_torch.compat.utils"]


def teardown_function(function):
    jax_register(None)
    port_register(None)


@pytest.mark.parametrize("shim,twin", TWINS, ids=[s for s, _ in TWINS])
def test_every_root_shim_name_resolves_in_its_twin(shim, twin):
    root = importlib.import_module(shim)
    port = importlib.import_module(f"image_transformation_tpu_torch.compat.{twin}")
    names = {n for n in vars(root) if not n.startswith(("__", "@"))}  # "@": pytest's rewrite
    assert names, shim
    assert names <= set(vars(port)), sorted(names - set(vars(port)))


def test_macro_placement_test_names_are_the_reference_surface():
    names = {n for n in vars(root_mpt) if not n.startswith(("__", "@"))} - {
        "annotations", "Dict", "List", "Tuple"}
    assert len(names) == 32
    assert port_mpt.main.__module__ == "image_transformation_tpu_torch.pipeline.cli"
    assert port_mpt.SCRIPT_DIR.is_dir()


@pytest.mark.parametrize("bundle", BUNDLES)
def test_nesting_conflicts_and_contact_sheet_equal_the_root_shim(bundle):
    results = f"data/{bundle}/results.json"
    for size, margin in (((369, 657), 0.05), ((657, 369), 0.1), ((492, 492), 0.0)):
        assert port_mpt._compute_nesting_conflicts(results, size, margin) == \
            root_mpt._compute_nesting_conflicts(results, size, margin)
    want = root_mpt._build_labeled_contact_sheet(f"data/{bundle}/objects", results)
    got = port_mpt._build_labeled_contact_sheet(f"data/{bundle}/objects", results,
                                                device="cpu")
    assert got.size == want.size and np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("bundle", BUNDLES)
def test_flex_helpers_equal_the_root_shim(bundle, tmp_path):
    from image_transformation_tpu_torch.core.bundle import load_bundle

    b = load_bundle(f"data/{bundle}")
    images = dict(b.objects)
    node = {"type": "flex", "direction": "row", "justify": "space_between", "gap": 7,
            "children": [{"object_id": oid} for oid in sorted(images)]}
    assert port_mpt._measure_flex_node(node, images) == root_mpt._measure_flex_node(node, images)
    placed = {}
    for name, mod in (("port", port_mpt), ("root", root_mpt)):
        out = []
        mod._place_flex_container(node, (10, 20), (600, 300), images, out, "middle_center")
        mod._clamp_boxes_to_canvas(out, (400, 250))
        mod._save_overlay_debug(out, (400, 250), tmp_path / f"{name}.png")
        placed[name] = out
    assert placed["port"] == placed["root"]
    assert np.array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                          np.asarray(Image.open(tmp_path / "root.png")))
    text = "noise ```json\n" + json.dumps({"root": node}) + "\n``` trailing"
    assert port_mpt._extract_json_maybe(text) == root_mpt._extract_json_maybe(text)
    for ratio in ("9:16", "1:1", "21:9", "4:1"):
        assert port_mpt._ratio_family(ratio) == root_mpt._ratio_family(ratio)
    assert port_mpt.read_original_size(f"data/{bundle}") == \
        root_mpt.read_original_size(f"data/{bundle}")
    labels = [it["label"] for it in json.loads(Path(f"data/{bundle}/results.json").read_text())]
    assert port_labels.compute_per_label_numbers(labels) == \
        root_labels.compute_per_label_numbers(labels)
    assert [port_labels.normalize_label(x) for x in labels] == \
        [root_labels.normalize_label(x) for x in labels]
    assert port_labels.ALLOWED_LABELS == root_labels.ALLOWED_LABELS


def test_main_writes_the_root_clis_tree(tmp_path):
    args = ["--bundle", "data/squarespace", "--ratio", "9:16", "--api", "fake",
            "--refine-iters", "1"]
    root_mpt.main(args + ["--output-root", str(tmp_path / "root")])
    out = port_mpt.main(args + ["--device", "cpu", "--output-root", str(tmp_path / "port")])
    a, b = tmp_path / "root" / "squarespace", tmp_path / "port" / "squarespace"
    assert out == b
    files = sorted(str(p.relative_to(a)) for p in a.rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(b)) for p in b.rglob("*") if p.is_file())
    drafts = [f for f in files if "draft_macro_iter_" in f]
    assert drafts
    for f in files:
        if f.endswith(".json"):
            assert json.loads((a / f).read_text()) == json.loads((b / f).read_text()), f
        elif f.endswith(".png"):
            assert np.array_equal(np.asarray(Image.open(a / f)),
                                  np.asarray(Image.open(b / f))), f
    for f in drafts:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def test_step_timer_writes_the_root_step_names(tmp_path):
    logs = {}
    for name, mod in (("port", port_timing), ("root", root_timing)):
        timer = mod.StepTimer()
        for step in ("prepare", "contact_sheet", "prepare", "compose_baseline"):
            with timer.time_step(step, echo=False):
                pass
        timer.write_to_file(str(tmp_path / f"{name}.txt"))
        logs[name] = [line.split(": ")[0]
                      for line in (tmp_path / f"{name}.txt").read_text().splitlines()]
    assert logs["port"] == logs["root"] == ["prepare", "contact_sheet", "compose_baseline"]


def test_layout_state_is_the_ports_agent_state():
    assert port_agentic.LayoutState is AgentState
    assert port_state.LayoutState is AgentState
    assert port_agentic.run_workflow.__module__ == "image_transformation_tpu_torch.agentic.workflow"
    assert root_agentic.LayoutState.__name__ == port_agentic.LayoutState.__name__


def test_new_modules_import_no_jax():
    code = (
        "import sys, importlib\n"
        f"for m in {NEW_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
        "'image_transformation_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
