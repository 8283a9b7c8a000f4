"""The batched step's program spans on the card: their device intervals
cover the step, and the spans never synchronise the host.

Every test here is marked ``cuda`` and skips without a card:
``python -m pytest tests/test_torch_spans_cuda.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.core.timing import reset_spans, span_summary
from image_transformation_tpu_torch.ops.compose_kernels import planarize_objects
from image_transformation_tpu_torch.parallel.sweep import make_solid_render_step, random_downscale_boxes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step's device intervals are CUDA events")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_render_and_stat_intervals_sum_to_the_step_without_a_host_sync(cuda, monkeypatch):
    B, H, W, STEPS = 64, 1920, 1080, 50
    arrays = load_bundle("data/squarespace").to_arrays()
    rng = np.random.default_rng(11)
    n = arrays.obj_hw.shape[0]
    sets = torch.from_numpy(np.stack([
        np.stack([random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(B)])
        for _ in range(8)])).to(cuda)
    hw = torch.from_numpy(np.broadcast_to(arrays.obj_hw, (B, n, 2)).copy()).to(cuda)
    static = tuple(tuple(int(v) for v in row) for row in arrays.obj_hw)
    step = make_solid_render_step((H, W), arrays.objects.shape[1:3], static_obj_hw=static,
                                  device="cuda")
    objs_p = planarize_objects(torch.from_numpy(arrays.objects[None]).to(cuda))
    for i in range(4):  # the fresh render, then reuse renders
        step(None, objs_p, hw, sets[i % 8])[1].cpu()
    # Under the profiler a step's host work (~2.5 ms) outlasts its device
    # work at B=64 (~0.6 ms), and the launch queue holds only so many
    # launches: so the card sleeps before each GROUP of steps while the host
    # enqueues it, and the group then runs back to back between its events.
    GROUP = 5
    marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(STEPS // GROUP)]
    syncs = []
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: syncs.append("device"))
        monkeypatch.setattr(torch.cuda.Event, "synchronize", lambda self: syncs.append("event"))
        for g, (start, end) in enumerate(marks):
            torch.cuda._sleep(200_000_000)
            start.record()
            for i in range(g * GROUP, (g + 1) * GROUP):
                step(None, objs_p, hw, sets[(4 + i) % 8])
            end.record()
        monkeypatch.undo()
        marks[-1][1].synchronize()
    assert syncs == []
    per_step = sum(start.elapsed_time(end) for start, end in marks) / STEPS
    spans = span_summary()["spans"]
    assert spans["itx.step"]["count"] == spans["itx.render"]["count"] == STEPS
    render, stat = spans["itx.render"]["device_ms_p50"], spans["itx.stat"]["device_ms_p50"]
    assert render > 0 and stat > 0
    print(f"render {render:.4f} ms + stat {stat:.4f} ms vs {per_step:.4f} ms a step")
    assert abs(render + stat - per_step) <= 0.05 * per_step
