"""Every script in image_transformation_tpu_torch/examples/ runs end to end.

The port's examples are the JAX package's examples/ on the port's
package; each runs here with ``--device cpu`` in a subprocess (its own
temporary directory) and must print the line tests/test_examples.py pins
for its JAX twin.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
EXAMPLES_DIR = REPO / "image_transformation_tpu_torch" / "examples"
EXAMPLES = sorted(EXAMPLES_DIR.glob("[0-9]*.py"))
#: the JAX twins' pinned lines (tests/test_examples.py)
PINNED = {
    "01_compose.py": "composed 369x657 canvas with 4 objects",
    "02_batch_ratios.py": "16:9: 657x369, 4 boxes",
    "03_pipeline_fake_vlm.py": "composed drafts: ['draft_macro_iter_00.png']",
    "04_serving_client.py": "stream: ratio=16:9",
    "05_multichip.py": "mesh: ",
    "06_agentic.py": "iterations: 2, placements: 4",
}


def test_examples_match_the_jax_examples_and_the_readme():
    """The port has a twin of every JAX example, under the same name, and
    its README lists exactly the scripts on disk."""
    jax_names = {p.name for p in (REPO / "examples").glob("[0-9]*.py")}
    on_disk = {p.name for p in EXAMPLES}
    assert on_disk == jax_names == set(PINNED)
    readme = (EXAMPLES_DIR / "README.md").read_text()
    assert set(re.findall(r"\b\d{2}_\w+\.py\b", readme)) == on_disk


@pytest.mark.parametrize("script", EXAMPLES, ids=lambda p: p.name)
def test_example_runs_on_the_cpu(script, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["TMPDIR"] = str(tmp_path)
    # one intra-op thread: the suite's other workers hold the cores, and
    # 04's daemon calibrates its device at idle with many small torch ops,
    # which thread oversubscription slows by orders of magnitude
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, str(script), "--device", "cpu"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (
        f"{script.name} exited {proc.returncode}\n--- stdout ---\n{proc.stdout}\n"
        f"--- stderr ---\n{proc.stderr}"
    )
    assert PINNED[script.name] in proc.stdout, proc.stdout
    assert str(tmp_path) in proc.stdout or script.name == "05_multichip.py", proc.stdout
