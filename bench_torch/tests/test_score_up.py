"""The ``score_up`` driver (cell ``squarespace_uhd.score916``) on the CPU at a
small size: its result line, the faults its check must catch, its control,
and its box generator at the cell's own size."""

import json
import math

import numpy as np
import pytest
import torch

from bench_torch import harness
from bench_torch.drivers import score_up

CELL = "squarespace_uhd.score916"
SEED = 2**31 + 17
#: 720 high x 405 wide keeps s0 = sqrt(720 * 405 / (970 * 250)) = 1.097, so the
#: top levels upscale, as the cell's do
SMALL = {"canvas_hw": [720, 405], "batch": 2, "box_sets": 3, "warmup_steps": 2, "samples": 3}


def _run(trace=False, patch=None, precision="exact"):
    return harness.run_cell(harness.load_cell(CELL), SEED, 0.5, trace, "cpu", overrides=SMALL,
                            patch=patch, precision=precision)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_and_reads_correct(trace, capsys):
    result = _run(bool(trace))
    harness.report(result)
    out, _ = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0, line["checks"]
    assert list(line["checks"]) == ["pixel_max_err", "luma_rel_err", "background_max_err"]
    assert line["checks"]["background_max_err"]["value"] == 0
    if trace:  # the per-layer metrics read nothing on the CPU
        assert line["metrics"] == {}
    else:
        assert set(line["metrics"]) == {"canvases_per_s", "setup_s"}


def _solid_restore(monkeypatch):
    """A step whose restore writes the gradient's first colour, c1, over every
    window instead of the ramp."""
    from image_transformation_tpu_torch.ops import compose_kernels as ck

    restore = ck.restore_windows

    def solid(plane, origins, extents, bg):
        if isinstance(bg, ck.GradientRamp):
            first = int(bg.values[0])
            bg = first
        return restore(plane, origins, extents, bg)

    monkeypatch.setattr(ck, "restore_windows", solid)


def test_a_restore_of_the_solid_first_colour_is_caught_off_the_boxes(monkeypatch):
    _solid_restore(monkeypatch)
    result = _run()
    assert result["correct"] is False
    bg = result["checks"]["background_max_err"]
    assert bg["value"] > bg["limit"]


def test_the_control_is_not_correct():
    cell = harness.load_cell(CELL)
    result = _run(precision=cell.mix["control"])
    assert result["correct"] is False, result["checks"]


def test_levels_and_bounds_at_the_cells_size():
    cell = harness.load_cell(CELL)
    p = cell.mix
    H, W = p["canvas_hw"]
    levels = score_up.scale_levels((H, W), cell.config["original_wh"], p["scale_levels"],
                                   p["scale_range"])
    s0 = math.sqrt(3840 * 2160 / (970 * 250))
    assert len(levels) == 12
    assert levels[0] == pytest.approx(0.5 * s0) and levels[-1] == pytest.approx(s0)
    obj_hw = np.array([[62, 230], [207, 357], [137, 257], [32, 131]])  # logo, photo, text, cta
    sizes = score_up.level_sizes(obj_hw, levels)
    assert sizes.shape == (4, 12, 2)
    assert sizes[:, -1].tolist() == [[363, 1345], [1211, 2088], [801, 1503], [187, 766]]
    assert len({tuple(s) for s in sizes.reshape(-1, 2).tolist()}) == 48
    pools = [score_up.up_pool(np.random.default_rng(seed), sizes, (H, W), 2, 64)
             for seed in (SEED, SEED, SEED + 1)]
    assert np.array_equal(pools[0], pools[1]) and not np.array_equal(pools[0], pools[2])
    boxes = pools[0].reshape(-1, 4, 4)
    assert (boxes[..., :2] >= 0).all() and (boxes[..., 2] <= W).all() and (boxes[..., 3] <= H).all()
    for k in range(4):  # every box is one of the object's 12 level sizes
        got = {(h, w) for h, w in zip((boxes[:, k, 3] - boxes[:, k, 1]).tolist(),
                                     (boxes[:, k, 2] - boxes[:, k, 0]).tolist())}
        assert got <= {tuple(s) for s in sizes[k].tolist()} and len(got) > 6
    with pytest.raises(ValueError):
        score_up.up_boxes(np.random.default_rng(0), sizes, (H, 1000))
    assert torch.get_default_dtype() == torch.float32
