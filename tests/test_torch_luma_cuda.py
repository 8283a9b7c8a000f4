"""The luma kernel (``csrc/packed_luma.cu``) against its plain version on
the card, bit for bit: both sum the channels exactly and do the same
float64 operations.

Every test here is marked ``cuda`` and skips without a card:
``python -m pytest tests/test_torch_luma_cuda.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bench_torch import trace
from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.core.timing import span
from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.parallel.sweep import make_solid_render_step, random_downscale_boxes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the luma kernel has no CPU mode")
    return torch.device("cuda", 0)


def _assert_kernel_is_plain(crop):
    got = ck.packed_luma(crop)
    want = ck.packed_luma_reference(crop)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (crop.shape[0],)
    assert torch.equal(got, want), (got - want).abs().max()
    return got


@pytest.mark.cuda
def test_rendered_1080p_plane(cuda):
    B, H, W = 8, 1920, 1080
    arrays = load_bundle("data/squarespace").to_arrays()
    rng = np.random.default_rng(3)
    n = arrays.obj_hw.shape[0]
    boxes = torch.from_numpy(np.stack(
        [random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(B)])).to(cuda)
    hw = torch.from_numpy(np.broadcast_to(arrays.obj_hw, (B, n, 2)).copy()).to(cuda)
    step = make_solid_render_step((H, W), arrays.objects.shape[1:3], stat="fence",
                                  bg_rgba=(30, 140, 220, 255), device="cuda")
    objs_p = ck.planarize_objects(torch.from_numpy(arrays.objects[None]).to(cuda))
    plane, _ = step(None, objs_p, hw, boxes)
    crop = plane[:, :H, :W]
    assert crop.stride(1) > W
    got = _assert_kernel_is_plain(crop)
    assert len(set(got.tolist())) > 1  # the objects moved the means apart


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 3, 129, 1080, 1081])
@pytest.mark.parametrize("col", [0, 1])
def test_random_planes(cuda, W, col):
    rng = np.random.default_rng(W + col)
    plane = torch.from_numpy(
        rng.integers(-2**31, 2**31, (5, 70, W + 7)).astype(np.int32)).to(cuda)
    _assert_kernel_is_plain(plane[:, 3:68, col:col + W])


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(2160, 3840), (4320, 7680)])
def test_white_canvases_with_channel_sums_near_and_past_32_bits(cuda, H, W):
    """A 4K canvas's channel sums, 2.115e9, reach 98.5% of 2^31; an 8K
    canvas's, 8.46e9, pass 2^32."""
    crop = torch.full((1, H, W), -1, dtype=torch.int32, device=cuda)
    got = _assert_kernel_is_plain(crop)
    wr, wg, wb = ck.REC709
    np.testing.assert_allclose(float(got[0]), (wr + wg + wb) * 255.0, rtol=1e-7)


@pytest.mark.cuda
def test_repeatable_counted_and_free_of_host_syncs(cuda):
    rng = np.random.default_rng(9)
    plane = torch.from_numpy(rng.integers(-2**31, 2**31, (16, 200, 1152)).astype(np.int32)).to(cuda)
    crop = plane[:, :190, :1080]
    first = ck.packed_luma(crop)
    before = ck.LAUNCHES["packed_luma"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = ck.packed_luma(crop)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ck.LAUNCHES["packed_luma"] == before + 1
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    plane = torch.zeros((2, 8, 16), dtype=torch.int32, device=cuda)
    before = ck.LAUNCHES["packed_luma"]
    with pytest.raises(TypeError):
        ck.packed_luma(plane.to(torch.int64))
    with pytest.raises(ValueError):
        ck.packed_luma(plane.transpose(1, 2))
    assert ck.LAUNCHES["packed_luma"] == before


@pytest.mark.cuda
def test_trace_places_both_launches_in_the_range_around_the_call(cuda):
    """As in the benchmark's traced step: the program span ``itx.stat``
    opens, then a caller's own range around ``packed_luma``; the trace
    links the kernel's two launches to the wrapper's launch range, so they
    fall in the caller's range and not before it."""
    crop = torch.zeros((4, 64, 1080), dtype=torch.int32, device=cuda)
    ck.packed_luma(crop)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            for _ in range(3):
                with record_function("bench.step"), span("itx.stat", cuda):
                    with record_function("bench.stat"):
                        ck.packed_luma(crop)
            torch.cuda.synchronize()
    spans = trace.reduce(trace.raw_events(prof))["spans"]
    assert spans["stat"]["launches"] == 6
    assert "step" not in spans or spans["step"]["launches"] == 0
