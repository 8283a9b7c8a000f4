"""The port as an installed package, on the CPU: the wheel built from the
tree carries every CUDA source and header and the agentic prompts, and a
package that is not in a source checkout builds its kernels into the
user's cache (``ops/_build.build_dir``).

The wheel is built from a copy of the packaging file and the port's
package (``pip wheel . --no-deps --no-build-isolation``: no network, no
dependency resolved), so the tree itself is never written to.
"""

import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

from image_transformation_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "image_transformation_tpu_torch"
CACHE = Path(".cache") / "image_transformation_tpu_torch" / "kernels"


def _copy_package(dst: Path) -> Path:
    """The port's package under ``dst``, less its bytecode caches."""
    shutil.copytree(PACKAGE, dst / PACKAGE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def _run_in(tree: Path, home: Path, code: str) -> subprocess.CompletedProcess:
    """``code`` in a fresh interpreter whose cwd and PYTHONPATH hold only
    ``tree``, with HOME at ``home``."""
    env = dict(os.environ, HOME=str(home), PYTHONPATH=str(tree))
    return subprocess.run([sys.executable, "-c", code], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    pytest.importorskip("setuptools", reason="building the wheel needs setuptools")
    src = _copy_package(tmp_path_factory.mktemp("src"))
    shutil.copy(ROOT / "pyproject.toml", src)
    dist = tmp_path_factory.mktemp("dist")
    r = subprocess.run([sys.executable, "-m", "pip", "wheel", ".", "--no-deps",
                        "--no-build-isolation", "-q", "-w", str(dist)],
                       cwd=src, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    (whl,) = dist.glob("*.whl")
    return whl


def _listing(names, prefix: str, suffixes):
    return sorted(n[len(prefix):] for n in names
                  if n.startswith(prefix) and n.endswith(suffixes) and "/" not in n[len(prefix):])


def test_wheel_carries_kernel_sources_headers_and_prompts(wheel):
    names = zipfile.ZipFile(wheel).namelist()
    csrc = _listing(names, "image_transformation_tpu_torch/csrc/", (".cu", ".cuh"))
    prompts = _listing(names, "image_transformation_tpu_torch/agentic/prompts/", (".txt",))
    assert csrc == sorted(p.name for p in (PACKAGE / "csrc").glob("*.cu*"))
    assert {n.rsplit(".", 1)[1] for n in csrc} == {"cu", "cuh"}
    assert prompts == sorted(p.name for p in (PACKAGE / "agentic" / "prompts").glob("*.txt"))
    (entry_points,) = [n for n in names if n.endswith(".dist-info/entry_points.txt")]
    assert ("macro-placement-torch = image_transformation_tpu_torch.pipeline.cli:main"
            in zipfile.ZipFile(wheel).read(entry_points).decode())


def test_unpacked_wheel_loads_its_prompts(wheel, tmp_path):
    tree = tmp_path / "site"
    zipfile.ZipFile(wheel).extractall(tree)
    r = _run_in(tree, tmp_path, (
        "from image_transformation_tpu_torch.agentic import nodes\n"
        "print(nodes.__file__)\n"
        "for name in ('macro_layouter', 'micro_layouter', 'critic'):\n"
        "    print(name, len(nodes.load_prompt(name)))\n"
    ))
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert Path(lines[0]).is_relative_to(tree)
    prompts = PACKAGE / "agentic" / "prompts"
    assert lines[1:] == [f"{n} {len((prompts / f'{n}.txt').read_text(encoding='utf-8'))}"
                         for n in ("macro_layouter", "micro_layouter", "critic")]


def test_checkout_builds_into_build_kernels():
    assert _build.build_dir() == ROOT / "build" / "kernels"
    assert _build.library_path().parent == ROOT / "build" / "kernels"


def test_package_outside_a_checkout_builds_into_the_user_cache(tmp_path):
    tree = _copy_package(tmp_path / "copy")
    home = tmp_path / "home"
    r = _run_in(tree, home, (
        "from image_transformation_tpu_torch.ops import _build\n"
        "print(_build.build_dir())\n"
        "print(_build.library_path().parent)\n"
        "print(_build.library_path().name)\n"
    ))
    assert r.returncode == 0, r.stderr
    build_dir, lib_dir, name = r.stdout.splitlines()
    assert Path(build_dir) == Path(lib_dir) == home / CACHE
    # the same sources, headers and flags: the checkout's library name
    assert name == _build.library_path().name


def test_missing_header_fails_the_build_naming_it(tmp_path):
    tree = _copy_package(tmp_path / "copy")
    (tree / PACKAGE.name / "csrc" / "resample.cuh").unlink()
    r = _run_in(tree, tmp_path / "home", (
        "from image_transformation_tpu_torch.ops import _build\n"
        "try:\n"
        "    _build.build()\n"
        "except RuntimeError as e:\n"
        "    print(e)\n"
    ))
    assert r.returncode == 0, r.stderr
    assert "fused_compose.cu includes resample.cuh" in r.stdout
    assert "fused_v3.cu includes resample.cuh" in r.stdout
    _build.check_includes()  # the checkout has every header
