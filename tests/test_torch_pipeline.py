"""The slice end to end: the port's CLI on the CPU against the JAX CLI.

Both CLIs run with --api fake --refine-iters 2 on data/squarespace at 9:16
into their own directories; the artifact trees, the layout JSONs and the
decoded drafts must be identical (tolerance 0). Also: the port imports no
jax, asks for CUDA explicitly and raises without it, and its engine never
writes into its base canvas.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import image_transformation_tpu_torch
from image_transformation_tpu.core.bundle import load_bundle as jax_load_bundle
from image_transformation_tpu.pipeline.cli import main as jax_main
from image_transformation_tpu.pipeline.engine import ComposeEngine as JaxEngine
from image_transformation_tpu.vlm.client import register_fake_client as jax_register
from image_transformation_tpu_torch.core.bundle import bundle_arrays_from_numpy
from image_transformation_tpu_torch.core.timing import StepTimer
from image_transformation_tpu_torch.pipeline.cli import main as port_main
from image_transformation_tpu_torch.pipeline.engine import ComposeEngine
from image_transformation_tpu_torch.vlm.client import register_fake_client as port_register

ROOT = Path(__file__).resolve().parents[1]
PORT_DIR = Path(image_transformation_tpu_torch.__file__).parent
ARGS = ["--bundle", "data/squarespace", "--ratio", "9:16", "--api", "fake",
        "--refine-iters", "2"]


def teardown_function(function):
    jax_register(None)
    port_register(None)


def _tree(base: Path):
    return sorted(str(p.relative_to(base)) for p in base.rglob("*") if p.is_file())


def test_port_cli_matches_jax_cli(tmp_path):
    jax_main(ARGS + ["--output-root", str(tmp_path / "jax")])
    out = port_main(ARGS + ["--device", "cpu", "--output-root", str(tmp_path / "port")])
    a, b = tmp_path / "jax" / "squarespace", tmp_path / "port" / "squarespace"
    assert out == b
    files = _tree(a)
    assert files == _tree(b)
    drafts = [f for f in files if "draft_macro_iter_" in f]
    layouts = [f for f in files if f.endswith(".json")]
    assert drafts and any("layout_macro_iter_" in f for f in layouts)
    for f in layouts:
        assert json.loads((a / f).read_text()) == json.loads((b / f).read_text()), f
    for f in [f for f in files if f.endswith(".png")]:
        assert np.array_equal(
            np.asarray(Image.open(a / f)), np.asarray(Image.open(b / f))
        ), f
    steps = [line.split(": ")[0] for line in (b / "time_log.txt").read_text().splitlines()]
    assert steps[:4] == ["prepare", "contact_sheet", "vlm_flex_baseline", "compose_baseline"]


def test_port_imports_no_jax_after_cpu_engine_run():
    code = (
        "import sys, numpy as np, torch\n"
        "from image_transformation_tpu_torch.core.bundle import load_bundle\n"
        "from image_transformation_tpu_torch.pipeline.engine import ComposeEngine\n"
        "import image_transformation_tpu_torch.pipeline.cli\n"
        "b = load_bundle('data/audio_book')\n"
        "canvas = np.full((300, 400, 4), 255, np.uint8)\n"
        "e = ComposeEngine(b.to_arrays(), canvas, torch.device('cpu'))\n"
        "out = e.compose([{'object_id': 1, 'box': [10, 20, 110, 150]}])\n"
        "assert out.shape == (300, 400, 4) and not bool((out == 255).all())\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'image_transformation_tpu.'))"
        " or m == 'image_transformation_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_no_port_module_imports_jax_or_the_jax_package():
    for path in sorted(PORT_DIR.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "image_transformation_tpu"), (
                    f"{path.relative_to(ROOT)} imports {name}"
                )


def test_cuda_device_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port_main(ARGS + ["--output-root", str(tmp_path)])  # --device defaults to cuda
    assert not (tmp_path / "squarespace").exists()


@pytest.mark.parametrize("bundle_name", ["squarespace", "audio_book"])
def test_cpu_engine_matches_jax_engine_and_keeps_its_base(bundle_name):
    jb = jax_load_bundle(f"data/{bundle_name}")
    ja = jb.to_arrays()
    arrays = bundle_arrays_from_numpy(ja.objects, ja.obj_hw, ja.object_ids)
    rng = np.random.default_rng(len(bundle_name))
    canvas = rng.integers(0, 256, (260, 420, 4), dtype=np.uint8)
    canvas[..., 3] = 255
    engine = ComposeEngine(arrays, canvas, torch.device("cpu"))
    jax_engine = JaxEngine(ja, canvas)
    sizes = jb.sizes()
    oids = sorted(sizes)
    for rep in range(2):
        placements = []
        for oid in list(oids) + [oids[0], 999]:  # repeated object, unknown id
            ow, oh = sizes.get(oid, (30, 30))
            s = float(rng.uniform(0.3, 1.0))
            w, h = max(1, int(ow * s)), max(1, int(oh * s))
            x1, y1 = int(rng.integers(0, 420 - 10)), int(rng.integers(0, 260 - 10))
            placements.append({"object_id": oid, "box": [x1, y1, x1 + w, y1 + h]})
        got = engine.compose(placements).numpy()
        assert np.array_equal(got, np.asarray(jax_engine.compose(placements)))
        assert np.array_equal(engine.canvas_dev.numpy(), canvas)  # base untouched
    assert np.array_equal(engine.compose([]).numpy(), canvas)
    ow, oh = sizes[oids[0]]
    with pytest.raises(ValueError, match="envelope"):
        engine.compose([{"object_id": oids[0], "box": [0, 0, 10 * ow, 10 * oh]}])


def test_step_timer_log_format(tmp_path):
    timer = StepTimer()
    with timer.time_step("prepare", echo=False):
        pass
    with timer.time_step("prepare", echo=False):
        pass
    with timer.time_step("compose_baseline", echo=False):
        pass
    path = tmp_path / "time_log.txt"
    timer.write_to_file(str(path))
    lines = path.read_text().splitlines()
    assert [line.split(": ")[0] for line in lines] == ["prepare", "compose_baseline"]
    assert all(line.endswith("s") for line in lines)
    again = StepTimer()
    again.load_from_file(path)
    assert set(again.summary()) == {"prepare", "compose_baseline"}
