"""The ``campaign`` driver (cell ``campaign_uhd.sweep4x64``): its box pool at
the cell's own size, the cell's files, and the cell on the CPU at a small
size, with its control."""

import json
import math

import numpy as np
import pytest

from bench_torch import harness, reference
from bench_torch.drivers import campaign, score_up

CELL = "campaign_uhd.sweep4x64"
SEED = 2**31 + 29
#: two ratios of a 160x90 budget, four canvases a step (two of each bundle)
SMALL = {"pixel_budget_wh": [160, 90], "ratios": ["9:16", "4:1"], "batch": 4, "box_sets": 2,
         "warmup_steps": 4, "samples": 4}


def _cell_sizes():
    """(cell, canvases (h, w) by ratio, per bundle level sizes [n, 12, 2])."""
    cell = harness.load_cell(CELL)
    cfg, mix = cell.config, cell.mix
    canvases = [reference.canvas_size(tuple(cfg["pixel_budget_wh"]), r)[::-1] for r in mix["ratios"]]
    levels = score_up.scale_levels(tuple(cfg["pixel_budget_wh"][::-1]), cfg["original_wh"],
                                   mix["scale_levels"], mix["scale_range"])
    sizes = []
    for path in cfg["bundles"]:
        _, objects = reference.load_bundle(harness.CHECKOUT / path)
        hw = np.array([objects[k].shape[:2] for k in sorted(objects)])
        sizes.append(score_up.level_sizes(hw, levels))
    return cell, canvases, sizes


def test_the_cell_resolves_with_its_config_mix_and_metrics():
    cell, canvases, _ = _cell_sizes()
    assert cell.chips == 1 and cell.mix["driver"] == "campaign"
    assert canvases == [(3840, 2160), (2880, 2880), (2160, 3840), (1440, 5760)]
    assert [m["name"] for m in cell.end_to_end] == ["canvases_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "render_roofline", "stat_roofline", "step.host_ms", "device.idle_share.batch",
        "step.stat_device_ms", "step.render_device_ms", "step.enqueue_ms", "step.meta_host_ms",
        "uhd.k2_chunks_per_step", "campaign.restore_roofline", "campaign.compose_roofline",
        "campaign.k3_line_restores_per_step"]
    assert cell.config["reduced"] == [] and len(cell.config["bundles"]) == 2


def test_the_box_pool_takes_fitting_levels_and_bundle_b_mod_2_from_the_seed():
    _, canvases, sizes = _cell_sizes()
    s0 = math.sqrt(3840 * 2160 / (970 * 250))
    assert sizes[1][1, -1].tolist() == [round(116 * s0), round(447 * s0)]  # audio_book's text
    assert int(campaign.fitting_levels(sizes[1], canvases[0])[1].sum()) == 8  # on 9:16
    for hw in canvases:
        a = campaign.campaign_boxes(np.random.default_rng(SEED), sizes, 4, hw, 64)
        b = campaign.campaign_boxes(np.random.default_rng(SEED), sizes, 4, hw, 64)
        c = campaign.campaign_boxes(np.random.default_rng(SEED + 1), sizes, 4, hw, 64)
        assert np.array_equal(a, b) and not np.array_equal(a, c)
        H, W = hw
        for canvas, boxes in enumerate(a):
            lv = sizes[canvas % 2]
            fits = campaign.fitting_levels(lv, hw)
            for k, (x1, y1, x2, y2) in enumerate(boxes.tolist()):
                if k >= lv.shape[0]:  # audio_book's empty fourth slot
                    assert (x1, y1, x2, y2) == (0, 0, 0, 0)
                    continue
                assert 0 <= x1 < x2 <= W and 0 <= y1 < y2 <= H
                level = [i for i in range(lv.shape[1]) if lv[k, i].tolist() == [y2 - y1, x2 - x1]]
                assert level and all(fits[k, i] for i in level)
        bounds = campaign.ratio_bounds(sizes, 4, hw)
        assert all(bh <= H and bw <= W for bh, bw in bounds)


@pytest.mark.parametrize("precision", ["exact", "bf16"], ids=["run", "control"])
def test_the_cell_reads_correct_and_its_control_does_not(precision, capsys):
    cell = harness.load_cell(CELL)
    result = harness.run_cell(cell, SEED, 0.3, False, "cpu", overrides=SMALL, precision=precision)
    harness.report(result)
    line = json.loads(capsys.readouterr()[0].strip().splitlines()[-1])
    assert list(line["checks"]) == ["pixel_max_err", "luma_rel_err", "background_max_err"]
    if precision == "exact":
        assert line["correct"] is True and line["attempted"] > 0, line["checks"]
        assert set(line["metrics"]) == {"canvases_per_s", "setup_s"}
    else:
        assert line["correct"] is False, line["checks"]


def _small_run(seconds=0.3):
    """The cell on the CPU at SMALL: (result, the driver)."""
    drivers = []
    result = harness.run_cell(harness.load_cell(CELL), SEED, seconds, False, "cpu",
                              overrides=SMALL, patch=drivers.append)
    return result, drivers[0]


def test_the_check_samples_every_ratio_and_bundle():
    result, driver = _small_run(0.5)
    assert result["correct"] is True, result["checks"]
    assert driver.attempted >= 2 * 2  # each ratio's reservoirs saw more steps than they keep
    strata = [(r, b % 2) for _, r, _, b in driver.sampled]
    assert sorted(strata) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_the_window_counts_its_work_for_the_accepted_metrics():
    from bench_torch.roofline import stat_bytes

    _, driver = _small_run()
    counters = driver.ctx.counters
    split = counters["work_split"]()
    assert set(split) == {"restore_bytes", "compose_bytes", "macs", "stat_bytes"}
    assert all(len(v) == counters["steps"] == driver.attempted for v in split.values())
    canvases = driver.canvases
    assert split["stat_bytes"] == [stat_bytes(SMALL["batch"], canvases[r]) for r, _ in driver.sets]
    assert counters["work"]() == (sum(split["restore_bytes"]) + sum(split["compose_bytes"]),
                                  sum(split["macs"]), sum(split["stat_bytes"]))
    assert counters["step_host_ms"] > 0 and "k2_chunks" not in counters  # no launches on the CPU
