"""K4's planar and stage entries (csrc/window_blend.cu) and every public
compose function of the port's ``ops`` on the card, against their plain
versions and the CPU, tolerance 0: the blends are integer arithmetic and
the resamples are exact, so the card and the CPU agree bit for bit.

Every test here is marked ``cuda`` and skips without a card:
``python -m pytest tests/test_torch_ops_variants_cuda.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch

from image_transformation_tpu_torch import ops
from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.parallel.sweep import random_downscale_boxes
from tests.test_torch_hybrid_cuda import _blend_case, _planar, live_blend_case


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4's entries have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_planar_entry_matches_plain_version_on_random_geometries(cuda):
    for seed in range(20):
        plane, src, meta = _blend_case(seed)
        plane_p, src_p = _planar(plane), _planar(src)
        want = ck.window_blend_planar_reference(plane_p.clone(), src_p, meta)
        before = ck.LAUNCHES["window_blend_planar"]
        got = ck.window_blend_planar(plane_p.to(cuda), src_p.to(cuda), meta.to(cuda))
        torch.cuda.synchronize()
        assert ck.LAUNCHES["window_blend_planar"] == before + 1
        assert torch.equal(got.cpu(), want), seed
        # the planar entry is the packed one on another layout
        assert torch.equal(want, _planar(ck.window_blend_reference(plane.clone(), src, meta)))


def _misaligned(t):
    """``t`` copied into storage that starts one byte past an allocation's
    start: its rows no longer start on 4-byte boundaries."""
    buf = torch.empty(t.numel() + 1, dtype=torch.uint8, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
def test_planar_entry_matches_plain_version_on_live_boxes(cuda):
    """Live boxes at odd columns, stacked placements sharing a 4-byte word
    of each plane, rectangles past every edge, invalid placements; plane
    and source widths off multiples of 4 (the entry's byte walk), and
    planes and sources whose storage starts off a 4-byte boundary."""
    for seed in range(40):
        plane, src, meta = live_blend_case(300 + seed)
        plane_p, src_p = _planar(plane), _planar(src)
        want = ck.window_blend_planar_reference(plane_p.clone(), src_p, meta)
        for shift in (False, True):
            got, s = plane_p.to(cuda), src_p.to(cuda)
            if shift:
                got, s = _misaligned(got), _misaligned(s)
            before = ck.LAUNCHES["window_blend_planar"]
            ck.window_blend_planar(got, s, meta.to(cuda))
            torch.cuda.synchronize()
            assert ck.LAUNCHES["window_blend_planar"] == before + 1
            assert torch.equal(got.cpu(), want), (seed, shift)


@pytest.mark.cuda
def test_stage_entry_matches_plain_version_on_live_boxes(cuda):
    for seed in range(20):
        plane, src, meta = live_blend_case(400 + seed)
        for variant in ck.STAGE_VARIANTS:
            want = ck.window_blend_stage_reference(plane.clone(), src, meta, variant)
            got = ck.window_blend_stage(plane.to(cuda), src.to(cuda), meta.to(cuda), variant)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (seed, variant)


@pytest.mark.cuda
def test_stage_entry_matches_plain_version_on_random_geometries(cuda):
    for seed in range(10):
        plane, src, meta = _blend_case(100 + seed)
        for variant in ck.STAGE_VARIANTS:
            want = ck.window_blend_stage_reference(plane.clone(), src, meta, variant)
            before = ck.LAUNCHES["window_blend_stage"]
            got = ck.window_blend_stage(plane.to(cuda), src.to(cuda), meta.to(cuda), variant)
            torch.cuda.synchronize()
            assert ck.LAUNCHES["window_blend_stage"] == before + 1
            assert torch.equal(got.cpu(), want), (seed, variant)


@pytest.mark.cuda
def test_public_functions_on_the_card_equal_the_cpu(cuda):
    arrays = load_bundle("data/squarespace").to_arrays()
    B, H, W = 3, 300, 520
    rng = np.random.default_rng(8)
    canvases = np.zeros((B, H, W, 4), np.uint8)
    canvases[..., :3] = 90
    canvases[..., 3] = 255
    objs = np.broadcast_to(arrays.objects, (B, *arrays.objects.shape)).copy()
    hw = np.broadcast_to(arrays.obj_hw, (B, *arrays.obj_hw.shape)).copy()
    boxes = np.stack([random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(B)])
    oh0, ow0 = (int(v) for v in hw[0, 0])
    boxes[0, 0] = [3, 5, 3 + ow0, 5 + oh0]  # identity size
    boxes[1, 1] = [W - 100, H - 50, W + 247, H + 66]  # hangs off the corner
    boxes[2, 2, :2] = -4  # dropped
    cpu = tuple(torch.from_numpy(x) for x in (canvases, objs, hw, boxes))
    card = tuple(x.to(cuda) for x in cpu)
    calls = {
        "hybrid": lambda c, o, h, b: ops.composite_batch_hybrid(c, o, h, b),
        "aligned": lambda c, o, h, b: ops.composite_batch_aligned(c, o, h, b),
        "pallas_host_tables": lambda c, o, h, b: ops.composite_batch_pallas_host_tables(
            c, o, h.cpu(), b.cpu()),
        **{flag: (lambda c, o, h, b, f=flag: ck.composite_batch_hybrid_packed(
            c, o, h, b, **{f: True})) for flag in ("rowbaked", "band", "batchsrc", "resident")},
    }
    for name, call in calls.items():
        want = call(*cpu)
        ck.reset_launch_counts()
        got = call(*card)
        torch.cuda.synchronize()
        assert sum(ck.LAUNCHES.values()) == 1, (name, ck.LAUNCHES)
        assert torch.equal(got.cpu(), want), name
    kh, kv, _, flags = ck.fused_tables_prep(hw[:1], boxes[:1], (H, W), objs.shape[2:4],
                                            objs.shape[2:4])
    want = ops.composite_canvas_tables(cpu[0][0], cpu[1][0], boxes[0], kh[0], kv[0],
                                       flags[0] & 2)
    got = ops.composite_canvas_tables(card[0][0], card[1][0], boxes[0], kh[0], kv[0],
                                      flags[0] & 2)
    assert torch.equal(got.cpu(), want)
