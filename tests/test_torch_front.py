"""The port's front-end modules against the JAX package's and the root
shims, on the CPU: the legacy grid/flow layout (layout/legacy.py),
RunConfig (core/config.py) and the reference-signature library modules
(compat/), which must equal the root ``compositor``, ``background_resizing``,
``layout_constraints`` and ``api_client`` byte for byte on both bundles.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import api_client
import background_resizing
import compositor
import layout_constraints
from image_transformation_tpu.core import config as jax_config
from image_transformation_tpu.layout import legacy as jax_legacy
from image_transformation_tpu_torch.compat import api_client as port_api_client
from image_transformation_tpu_torch.compat import background_resizing as port_background
from image_transformation_tpu_torch.compat import compositor as port_compositor
from image_transformation_tpu_torch.compat import layout_constraints as port_layout
from image_transformation_tpu_torch.core import config as port_config
from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.layout import legacy

ROOT = Path(__file__).resolve().parents[1]
BUNDLES = ("squarespace", "audio_book")

NEW_MODULES = (
    "image_transformation_tpu_torch.parallel.mesh",
    "image_transformation_tpu_torch.parallel.sweep",
    "image_transformation_tpu_torch.pipeline.fused",
    "image_transformation_tpu_torch.pipeline.fleet",
    "image_transformation_tpu_torch.layout.legacy",
    "image_transformation_tpu_torch.core.config",
    "image_transformation_tpu_torch.ui.console",
    "image_transformation_tpu_torch.ui.web",
    "image_transformation_tpu_torch.ui.headless",
    "image_transformation_tpu_torch.ui.app",
    "image_transformation_tpu_torch.ui.agentic_app",
    "image_transformation_tpu_torch.compat.compositor",
    "image_transformation_tpu_torch.compat.background_resizing",
    "image_transformation_tpu_torch.compat.layout_constraints",
    "image_transformation_tpu_torch.compat.api_client",
)


def _placements(p):
    return [(q.object_id, q.cell, tuple(q.box), q.scale) for q in p]


@pytest.mark.parametrize("bundle", BUNDLES)
def test_legacy_layout_matches_jax(bundle):
    rj = f"data/{bundle}/results.json"
    assign = legacy.baseline_cell_assignments(rj)
    assert assign == jax_legacy.baseline_cell_assignments(rj)
    meta = legacy.load_object_meta(f"data/{bundle}/objects", rj)
    jmeta = jax_legacy.load_object_meta(f"data/{bundle}/objects", rj)
    assert {k: dataclasses.astuple(v) for k, v in meta.items()} == \
        {k: dataclasses.astuple(v) for k, v in jmeta.items()}
    for align in ("center", "edge"):
        cells = port_layout.grid_cells((900, 700), 0.05)
        fin = legacy.finalize_layout(assign, rj, (900, 700), cells, align)
        jfin = jax_legacy.finalize_layout(assign, rj, (900, 700), cells, align)
        assert _placements(fin) == _placements(jfin)
        assert legacy.layout_final_json(fin, (900, 700), 0.05, align) == \
            jax_legacy.layout_final_json(jfin, (900, 700), 0.05, align)
    objs = [meta[k] for k in sorted(meta)]
    jobjs = [jmeta[k] for k in sorted(jmeta)]
    for params in ({"align": "center"}, {"align": "left", "orientation": "horizontal"},
                   {"orientation": "vertical", "global_spacing_px": 7}):
        p, size = legacy.pack_flow(objs, (600, 500), dict(params), meta)
        jp, jsize = jax_legacy.pack_flow(jobjs, (600, 500), dict(params), jmeta)
        assert size == jsize and _placements(p) == _placements(jp)
        assert legacy.layout_final_json(p, size, 0.1, "center") == \
            jax_legacy.layout_final_json(jp, jsize, 0.1, "center")


@pytest.mark.parametrize("base_output_root", [None, Path("runs/out")])
def test_run_config_to_dict_matches_jax(base_output_root):
    kw = dict(ratio="9:16", margin=0.1, api_key="secret", refine_iters=3,
              base_output_root=base_output_root, planner_addendum="x")
    got = port_config.RunConfig(**kw, device="cpu").to_dict()
    assert got == jax_config.RunConfig(**kw).to_dict()
    assert "api_key" not in got and "device" not in got
    assert port_config.RunConfig("1:1").device == "cuda"
    fields = [f.name for f in dataclasses.fields(port_config.RunConfig)]
    assert fields == [f.name for f in dataclasses.fields(jax_config.RunConfig)] + ["device"]


def test_run_with_config_runs_on_the_named_device(tmp_path):
    """run_with_config on device "cpu" writes the JAX run's tree and
    drafts (fake client, no refinement)."""
    from image_transformation_tpu.pipeline.cli import install_fake_client as jax_fake
    from image_transformation_tpu.vlm.client import register_fake_client as jax_register
    from image_transformation_tpu_torch.pipeline.cli import install_fake_client
    from image_transformation_tpu_torch.vlm.client import register_fake_client

    bundle = ROOT / "data" / "squarespace"
    kw = dict(ratio="9:16", refine_iters=0)
    jax_fake(bundle)
    install_fake_client(bundle)
    try:
        a = jax_config.run_with_config(bundle, jax_config.RunConfig(
            **kw, base_output_root=tmp_path / "jax"))
        b = port_config.run_with_config(bundle, port_config.RunConfig(
            **kw, base_output_root=tmp_path / "port", device="cpu"))
    finally:
        jax_register(None)
        register_fake_client(None)
    files = sorted(str(p.relative_to(a)) for p in a.rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(b)) for p in b.rglob("*") if p.is_file())
    pngs = [f for f in files if f.endswith(".png")]
    assert any("draft_macro_iter_00" in f for f in pngs)
    for f in pngs:
        assert np.array_equal(np.asarray(Image.open(a / f)), np.asarray(Image.open(b / f))), f


@pytest.mark.parametrize("bundle", BUNDLES)
def test_compat_compositor_matches_the_root_shim(bundle):
    b = load_bundle(f"data/{bundle}")
    objs = b.objects
    ids = sorted(objs)
    bg = Image.open(f"data/{bundle}/background.png")
    # every object at its own scale (an upscale and a down), plus an id
    # the bundle does not have, which both skip
    placements = [
        {"object_id": oid, "box": [5 + 30 * i, 7 + 20 * i,
                                   5 + 30 * i + objs[oid].size[0] * (i + 1) // 3 + 9,
                                   7 + 20 * i + objs[oid].size[1] // 2 + 3]}
        for i, oid in enumerate(ids)
    ] + [{"object_id": 999, "box": [0, 0, 5, 5]}]
    want = np.asarray(compositor.composite(bg, objs, placements))
    got = np.asarray(port_compositor.composite(bg, objs, placements, device="cpu"))
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    empty = port_compositor.composite(bg, objs, [{"object_id": 999, "box": [0, 0, 1, 1]}],
                                      device="cpu")
    assert np.array_equal(np.asarray(empty), np.asarray(bg.convert("RGBA")))


@pytest.mark.parametrize("bundle", BUNDLES)
def test_compat_background_fills_match_the_root_shim(bundle):
    path = f"data/{bundle}/background.png"
    for size in ((64, 40), (257, 131), (321, 123)):
        for fn in ("fill_solid", "fill_gradient"):
            want = np.asarray(getattr(background_resizing, fn)(path, size))
            got = np.asarray(getattr(port_background, fn)(path, size, device="cpu"))
            assert np.array_equal(got, want), (fn, size)


def test_compat_layout_and_api_client_names_match_the_root_shims():
    for mod, root_mod in ((port_layout, layout_constraints), (port_api_client, api_client)):
        names = {n for n in vars(root_mod) if not n.startswith("__")} - {
            "annotations"}
        assert names <= set(vars(mod)), names - set(vars(mod))
    for ratio in ("9:16", "1:1", "21:9"):
        assert port_layout.compute_canvas_size((970, 250), ratio, verbose=False) == \
            layout_constraints.compute_canvas_size((970, 250), ratio, verbose=False)
        assert port_layout.grid_cells((900, 700), 0.05) == \
            layout_constraints.grid_cells((900, 700), 0.05)
    assert port_api_client.NEBIUS_DEFAULT_VLM == api_client.NEBIUS_DEFAULT_VLM


def test_new_modules_import_no_jax():
    """Every module this slice added imports neither jax nor the JAX
    package (a fresh interpreter, its sys.modules read after)."""
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
