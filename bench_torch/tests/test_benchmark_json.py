"""BENCHMARK.json keeps the contract's shape, and every file it implies resolves by name."""

import json
import re
from pathlib import Path

import pytest

from bench_torch import harness

ROOT = Path(harness.CHECKOUT)
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["bench_torch"] and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 << 10
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert e2e == {"canvases_per_s", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_names_units_and_metric_wiring():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + metrics]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    cells = {w["name"]: w for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:  # setup_s, one more end-to-end metric and one per-layer metric
        reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", cells)]
        assert {"setup_s"} < {m["name"] for m in reported}
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


PENDING = json.loads((harness.HERE / "pending_cells.json").read_text())
ALL = {k: BENCH[k] + PENDING[k] for k in ("configs", "workloads", "end_to_end", "per_layer")}


@pytest.mark.parametrize("cell", [w["name"] for w in ALL["workloads"]])
def test_every_file_of_a_cell_resolves(cell):
    """The benchmark's cells and the pending ones."""
    c = harness.load_cell(cell, ALL)
    w = next(x for x in ALL["workloads"] if x["name"] == cell)
    assert w["chips"] == 1 and c.mix["driver"]
    assert (harness.HERE / "drivers" / f"{c.mix['driver']}.py").is_file()
    assert (ROOT / c.config["bundle"] / "results.json").is_file()
    for m in c.per_layer:
        assert callable(harness._module(harness.HERE / "metrics" / f"{m['name']}.py").read)
    cfg = next(x for x in ALL["configs"] if x["name"] == w["config"])
    assert (ROOT / cfg["file"]).is_file() and cfg["file"].startswith("bench_torch/")
    assert set(c.mix["limits"]) and c.mix["control"]
