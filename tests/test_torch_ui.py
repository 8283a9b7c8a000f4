"""The port's front ends (ui/) against the JAX package's, on the CPU.

The headless driver runs the port's Streamlit apps (main and agentic) with
the fake client on ``device="cpu"`` and JAX's apps through JAX's
``run_app``, each in its own repo root: the artifact trees, the drafts and
the layout JSON must be equal, and so must the widget transcripts (the
page titles aside). The console and web viewers, copies, must print and
serve what JAX's print and serve on the same run root.
"""

import json
import re
import shutil
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import image_transformation_tpu.ui.agentic_app as jax_agentic_app
import image_transformation_tpu.ui.app as jax_app
import image_transformation_tpu_torch.ui.agentic_app as agentic_app
import image_transformation_tpu_torch.ui.app as app
from image_transformation_tpu.ui import console as jax_console
from image_transformation_tpu.ui import headless as jax_headless
from image_transformation_tpu.ui import web as jax_web
from image_transformation_tpu.vlm.client import register_fake_client as jax_register
from image_transformation_tpu_torch.ui import console, headless, web
from image_transformation_tpu_torch.vlm.client import register_fake_client

REPO = Path(__file__).resolve().parents[1]


def _root(base: Path) -> Path:
    """A repo root of the apps: the real bundles (read only), outputs here."""
    base.mkdir()
    (base / "data").symlink_to(REPO / "data")
    (base / "input").mkdir()
    for name in ("squarespace.jpg", "audio_book.jpg"):
        shutil.copy(REPO / "input" / name, base / "input" / name)
    return base


@pytest.fixture
def roots(tmp_path, monkeypatch):
    jroot, proot = _root(tmp_path / "jax"), _root(tmp_path / "port")
    monkeypatch.setattr(jax_app, "REPO_ROOT", jroot)
    monkeypatch.setattr(jax_agentic_app, "REPO_ROOT", jroot)
    monkeypatch.setattr(app, "REPO_ROOT", proot)
    monkeypatch.setattr(agentic_app, "REPO_ROOT", proot)
    yield jroot, proot
    jax_register(None)
    register_fake_client(None)


def _tree(base: Path):
    return sorted(str(p.relative_to(base)) for p in base.rglob("*") if p.is_file())


def _calls(st, root: Path):
    """The transcript as (kind, label, value), with the run root and the
    timing log's seconds elided and the page title and config left out (the
    port names its own)."""
    out = []
    for c in st.calls:
        if c.kind in ("title", "set_page_config"):
            continue
        label = re.sub(r"\d+\.\d+s\b", "<t>s", c.label.replace(str(root), "<root>"))
        out.append((c.kind, label, str(c.value).replace(str(root), "<root>")))
    return out


def _assert_same_run(a: Path, b: Path):
    files = _tree(a)
    assert files == _tree(b)
    drafts = [f for f in files if f.endswith(".png")]
    layouts = [f for f in files if f.endswith(".json")]
    assert any("draft_" in f for f in drafts) and layouts
    for f in drafts:
        assert np.array_equal(np.asarray(Image.open(a / f)), np.asarray(Image.open(b / f))), f
    for f in layouts:
        assert json.loads((a / f).read_text()) == json.loads((b / f).read_text()), f
    return files


MAIN_PASSES = (
    {"select_squarespace.jpg": True},
    {"VLM backend": "fake (hermetic)", "Refine iterations": 1, "Run macro placement": True},
    {"iter_idx": 1},
)


def test_main_app_matches_jax(roots):
    jroot, proot = roots
    jst, pst = jax_headless.HeadlessStreamlit(), headless.HeadlessStreamlit()
    for values in MAIN_PASSES:
        if "iter_idx" in values:  # browse the second iteration
            jst.session_state["iter_idx"] = pst.session_state["iter_idx"] = 1
            values = {}
        jax_headless.run_app("main", jst, dict(values))
        headless.run_app("main", pst, dict(values), device="cpu")
        assert _calls(pst, proot) == _calls(jst, jroot)
    assert pst.session_state["has_run"] is True
    files = _assert_same_run(jroot / "output_macro_placement" / "squarespace",
                             proot / "output_macro_placement" / "squarespace")
    assert "iteration_00/final_product/draft_macro_iter_00.png" in files


def test_agentic_app_matches_jax(roots):
    jroot, proot = roots
    values = {"VLM backend": "fake (hermetic)", "Bundle": "squarespace", "Micro iterations": 1,
              "Run agentic workflow": True}
    jst = jax_headless.run_app("agentic", values=dict(values))
    pst = headless.run_app("agentic", values=dict(values), device="cpu")
    assert any(c.kind == "empty.success" for c in pst.calls), pst.transcript()
    assert _calls(pst, proot) == _calls(jst, jroot)
    a, b = Path(jst.session_state["agentic_run"]), Path(pst.session_state["agentic_run"])
    assert a.relative_to(jroot) == b.relative_to(proot)
    _assert_same_run(a, b)


def test_headless_cli_passes_the_device(roots, capsys, monkeypatch):
    seen = {}
    monkeypatch.setattr(app, "main", lambda device: seen.setdefault("device", device))
    headless.main(["main", "--device", "cpu"])
    assert seen == {"device": "cpu"}
    monkeypatch.undo()
    headless.main(["main", "--device", "cpu", "--set", "Ratio W=16", "--set", "Ratio H=9"])
    out = capsys.readouterr().out
    assert "<title 'Macro Placement" in out and "<number_input 'Ratio W' -> 16>" in out


@pytest.fixture
def run_root(tmp_path):
    """One port run (fake client, one refinement) to browse."""
    from image_transformation_tpu_torch.pipeline.fleet import install_generic_fake_client
    from image_transformation_tpu_torch.pipeline.run import run_macro_only

    install_generic_fake_client()
    try:
        run_macro_only("data/squarespace", "9:16", "center", 0.05, refine_iters=1,
                       base_output_root=tmp_path, device="cpu")
    finally:
        register_fake_client(None)
    return tmp_path


def test_console_matches_jax(run_root, capsys):
    assert console.list_runs(run_root) == jax_console.list_runs(run_root)
    assert console.show_run(run_root, "squarespace") == jax_console.show_run(run_root,
                                                                            "squarespace")
    for argv in (["--root", str(run_root), "list"],
                 ["--root", str(run_root), "show", "squarespace"],
                 ["--root", str(run_root), "show", "squarespace", "--iter", "1", "--json"]):
        jax_console.main(argv)
        want = capsys.readouterr().out
        console.main(argv)
        assert capsys.readouterr().out == want and "squarespace" in want


def test_web_viewer_matches_jax(run_root):
    servers = [web.serve(run_root, port=0), jax_web.serve(run_root, port=0)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for t in threads:
        t.start()
    try:
        def get(server, path):
            url = f"http://127.0.0.1:{server.server_address[1]}{path}"
            try:
                with urllib.request.urlopen(url, timeout=30) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        for path in ("/", "/run/squarespace", "/api/runs", "/api/run/squarespace",
                     "/file/squarespace/iteration_00/final_product/draft_macro_iter_00.png",
                     "/file/squarespace/../../etc/passwd", "/run/nope"):
            got, want = get(servers[0], path), get(servers[1], path)
            assert got == want, path
        assert get(servers[0], "/run/squarespace")[0] == 200
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
