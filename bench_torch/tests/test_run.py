"""The result line's shape, and runs that must fail: no card, no program."""

import json
import shutil
import subprocess
import sys

import pytest

from bench_torch import harness

SMALL = {
    "squarespace.score1080": {"canvas_hw": [480, 400], "batch": 4, "box_sets": 3, "warmup_steps": 2},
    "audio_book.draft916": {"layout_pool": 64, "warmup_drafts": 4},
    "squarespace.fleet8": {"pixel_budget_wh": [320, 180], "layout_pool": 64, "warmup_passes": 2},
    "audio_book.serve916": {"rate": 20, "warmup_ramp": [[1.0, 0.5]],
                            "settle_seconds": 0.2, "workers": 8},
}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]

def load(cell: str) -> harness.Cell:
    """A cell of BENCHMARK.json or a pending one."""
    return harness.load_cell(cell, pending=True)


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("trace", [0, 1])
def test_the_last_line_has_the_contract_keys(cell, trace, capsys):
    c = load(cell)
    result = harness.run_cell(c, 2**31 + 99, 0.5, bool(trace), "cpu", overrides=SMALL[cell])
    harness.report(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    names = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_a_run_without_a_card_fails_and_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "bench_torch.run", "--workload",
                        "squarespace.score1080", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=harness.CHECKOUT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "jax" not in p.stderr.lower() or "no cuda card" in p.stderr.lower()


def test_a_checkout_of_only_the_benchmark_fails(tmp_path):
    shutil.copy(harness.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "bench_torch.run", "--workload",
                        "squarespace.score1080", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "image_transformation_tpu_torch" in p.stderr


def test_the_harness_imports_no_jax():
    code = ("import sys, bench_torch.run, bench_torch.harness, bench_torch.daemon, "
            "bench_torch.reference, bench_torch.roofline, bench_torch.trace\n"
            "from bench_torch.drivers import score, draft, fleet, serve\n"
            "import image_transformation_tpu_torch.serving.server, "
            "image_transformation_tpu_torch.pipeline.fused, "
            "image_transformation_tpu_torch.parallel.sweep\n"
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], cwd=harness.CHECKOUT, check=True, timeout=120)
