"""The port's fleet runner (pipeline/fleet.py) and the CLI's --variants
against the JAX package's, on the CPU.

run_fleet(device="cpu") and JAX's run_fleet render both bundles at the
fleet's ratios into their own directories: the file trees, the layouts and
the boxes must be equal, the PNGs within 1 (of 255; the JAX runner's
default is its XLA compose, the port's K2's plain version: JAX's own
cross-program envelope, tests/test_fused_render.py:106). The same holds
for the CLI's --variants. The port raises where JAX would fall back or
shard: a K2 failure, --mesh over nccl on the CPU, and CUDA without a card.
(The mesh paths themselves: tests/test_torch_mesh.py.)
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from image_transformation_tpu.pipeline.cli import main as jax_cli
from image_transformation_tpu.pipeline.fleet import run_fleet as jax_run_fleet
from image_transformation_tpu.vlm.client import register_fake_client as jax_register
from image_transformation_tpu_torch.pipeline import fleet, fused
from image_transformation_tpu_torch.pipeline.cli import main as port_cli
from image_transformation_tpu_torch.vlm.client import register_fake_client as port_register

ROOT = Path(__file__).resolve().parents[1]
BUNDLES = [Path("data/squarespace"), Path("data/audio_book")]
RATIOS = ["9:16", "1:1", "16:9", "4:1"]


def teardown_function(function):
    jax_register(None)
    port_register(None)


def _tree(base: Path):
    return sorted(str(p.relative_to(base)) for p in base.rglob("*") if p.is_file())


def _assert_pngs_within_one(a: Path, b: Path, names):
    for name in names:
        x = np.asarray(Image.open(a / name)).astype(int)
        y = np.asarray(Image.open(b / name)).astype(int)
        assert x.shape == y.shape, name
        assert np.abs(x - y).max() <= 1, name


def test_run_fleet_matches_jax(tmp_path):
    want = jax_run_fleet(BUNDLES, RATIOS, output_root=tmp_path / "jax")
    got = fleet.run_fleet(BUNDLES, RATIOS, output_root=tmp_path / "port", device="cpu",
                          reps=2)
    a, b = tmp_path / "jax", tmp_path / "port"
    assert _tree(a) == _tree(b)
    assert got["total_canvases"] == 2 * want["total_canvases"]  # reps=2
    assert got["device"] == "cpu" and got["devices"] == 1
    for stem in ("squarespace", "audio_book"):
        g, w = got["bundles"][stem], want["bundles"][stem]
        assert g["canvas_sizes"] == w["canvas_sizes"]
        assert g["layout_source"] == w["layout_source"] == "fallback:column"
        for f in ("boxes.json", "fleet_layout_used.json"):
            assert json.loads((a / stem / f).read_text()) == json.loads((b / stem / f).read_text())
        _assert_pngs_within_one(a / stem, b / stem,
                                [f"variant_{r.replace(':', 'x')}.png" for r in RATIOS])
    assert json.loads((b / "fleet_summary.json").read_text())["total_canvases"] == 16


def test_fleet_cli_pixel_budget_and_explicit_layout(tmp_path, capsys):
    layout = {"root": {"type": "flex", "direction": "row",
                       "children": [{"object_id": 2, "name": "photo"}]}}
    path = tmp_path / "layout.json"
    path.write_text(json.dumps(layout))
    fleet.main(["--bundles", "data/squarespace", "--ratios", "1:1,21:9",
                "--output-root", str(tmp_path / "out"), "--layout-json", str(path),
                "--pixel-budget", "640x360", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["bundles"] == 1 and line["total_canvases"] == 2
    summary = json.loads((tmp_path / "out" / "fleet_summary.json").read_text())
    assert summary["bundles"]["squarespace"]["layout_source"].startswith("file:")
    used = json.loads((tmp_path / "out" / "squarespace" / "fleet_layout_used.json").read_text())
    assert used == layout
    w, h = Image.open(tmp_path / "out" / "squarespace" / "variant_21x9.png").size
    assert [w, h] == summary["bundles"]["squarespace"]["canvas_sizes"]["21:9"]


def test_a_k2_failure_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("fused_v3: kernel launch failed")

    monkeypatch.setattr(fused, "fused_v3", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        fleet.run_fleet(BUNDLES[:1], ["1:1"], output_root=tmp_path, device="cpu")
    assert not (tmp_path / "squarespace").exists()
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        fleet.main(["--bundles", "data/squarespace", "--ratios", "1:1", "--device", "cpu",
                    "--output-root", str(tmp_path)])


def test_mesh_and_missing_card_raise(tmp_path, monkeypatch):
    # --mesh names its backend (nccl by default), which is never switched
    # to gloo on the caller's behalf: nccl on the CPU raises
    with pytest.raises(ValueError, match="nccl"):
        fleet.main(["--bundles", "data/squarespace", "--mesh", "--device", "cpu",
                    "--output-root", str(tmp_path)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        fleet.run_fleet(BUNDLES[:1], ["1:1"], output_root=tmp_path)  # device="cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        fleet.main(["--bundles", "data/squarespace", "--output-root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="is_available"):
        port_cli(["--bundle", "data/squarespace", "--ratio", "9:16", "--api", "fake",
                  "--refine-iters", "1", "--variants", "1:1",
                  "--output-root", str(tmp_path / "cli")])
    assert not any(tmp_path.iterdir())


def test_cli_variants_match_jax(tmp_path):
    args = ["--bundle", "data/audio_book", "--ratio", "9:16", "--api", "fake",
            "--refine-iters", "1", "--variants", "1:1,16:9,4:1"]
    jax_cli(args + ["--output-root", str(tmp_path / "jax")])
    out = port_cli(args + ["--device", "cpu", "--output-root", str(tmp_path / "port")])
    a = tmp_path / "jax" / "audio_book" / "variants"
    b = tmp_path / "port" / "audio_book" / "variants"
    assert out == tmp_path / "port" / "audio_book"
    names = [f"variant_{r}.png" for r in ("9x16", "1x1", "16x9", "4x1")]
    assert _tree(a) == _tree(b) == sorted(names)
    _assert_pngs_within_one(a, b, names)


def test_full_loop_fleet_runs_the_port_pipeline(tmp_path, capsys):
    fleet.main(["--bundles", "data/squarespace,data/audio_book", "--ratios", "1:1",
                "--full-loop", "--api", "fake", "--refine-iters", "1", "--parallel", "2",
                "--device", "cpu", "--output-root", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"bundles": 2, "ok": 2, "errors": {}}
    for name in ("squarespace", "audio_book"):
        assert list((tmp_path / name).glob("iteration_*/final_product/draft_macro_iter_*.png"))
    # a later fleet run picks the loop's final layout up
    summary = fleet.run_fleet(BUNDLES[:1], ["1:1"], output_root=tmp_path / "again",
                              device="cpu", save=False)
    assert summary["bundles"]["squarespace"]["layout_source"] == "fallback:column"
    summary = fleet.run_fleet(BUNDLES[:1], ["1:1"], output_root=tmp_path, device="cpu",
                              save=False)
    assert summary["bundles"]["squarespace"]["layout_source"] == "previous_run"


def test_importing_the_new_modules_loads_no_kernel_and_no_jax():
    code = (
        "import sys\n"
        "import image_transformation_tpu_torch.pipeline as p\n"
        "from image_transformation_tpu_torch.pipeline import fleet, fused, cli\n"
        "from image_transformation_tpu_torch.layout import solve, validate_vec\n"
        "from image_transformation_tpu_torch.ops import _build\n"
        "assert p.fused_multi_ratio_render and p.make_fused_render\n"
        "assert _build._LIB is None\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
        "'image_transformation_tpu.')) or m == 'image_transformation_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
