"""K4 (the packed window blend, csrc/window_blend.cu) and the hybrid compose
on the card against their plain versions, tolerance 0: the blend is integer
arithmetic, and the producer's resample is the exact float64 one, so the
card and the CPU agree bit for bit.

Every test here is marked ``cuda`` and skips without a card:
``python -m pytest tests/test_torch_hybrid_cuda.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch

from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.ops import resize as prz
from image_transformation_tpu_torch.parallel.sweep import random_downscale_boxes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 has no CPU mode")
    return torch.device("cuda", 0)


def _blend_case(seed):
    """A random plane and packed sources (random alpha, with fully clear and
    fully opaque pixels) and the window meta of random boxes: overlapping,
    flush against the right and bottom edges, hanging off them, and dropped
    origins; the clamped or the unclamped geometry; N up to 8."""
    rng = np.random.default_rng(seed)
    B, N = int(rng.integers(1, 4)), int(rng.integers(1, 9))
    mh, mw = 8 * int(rng.integers(1, 16)), 128 * int(rng.integers(1, 4))
    H, W = int(rng.integers(8, 300)), int(rng.integers(8, 500))
    clamp = bool(rng.integers(0, 2))
    MH, MW = ck.window_extents((mh, mw))
    if clamp:
        hp, wp = max(ck._round_up(H, 8), MH), max(ck._round_up(W, 128), MW)
    else:
        hp, wp = ck._legacy_canvas_pad_hw((H, W), (MH, MW))
    plane = rng.integers(-2**31, 2**31, (B, hp, wp), dtype=np.int64).astype(np.int32)
    src = rng.integers(-2**31, 2**31, (B, N, mh, mw), dtype=np.int64).astype(np.int32)
    src[rng.random(src.shape) < 0.3] &= 0x00FFFFFF  # alpha 0
    src[rng.random(src.shape) < 0.2] |= -0x1000000  # alpha 255
    boxes = np.zeros((B, N, 4), np.int64)
    for b in range(B):
        for k in range(N):
            bh, bw = int(rng.integers(1, mh + 1)), int(rng.integers(1, mw + 1))
            mode = int(rng.integers(0, 4))
            if mode == 0:  # flush against the bottom-right corner
                x1, y1 = W - bw, H - bh
            elif mode == 1:  # hanging off the right and bottom edges
                x1, y1 = W - bw // 2, H - bh // 2
            else:  # anywhere, incl. negative and off-canvas (dropped) origins
                x1, y1 = int(rng.integers(-5, W + 3)), int(rng.integers(-5, H + 3))
            boxes[b, k] = (x1, y1, x1 + bw, y1 + bh)
    cap = (hp - MH, wp - MW) if clamp else None
    meta = ck._window_meta6(torch.from_numpy(boxes), (H, W), origin_cap=cap)
    return torch.from_numpy(plane), torch.from_numpy(src), meta.contiguous()


@pytest.mark.cuda
def test_k4_matches_plain_version_on_random_geometries(cuda):
    for seed in range(20):
        plane, src, meta = _blend_case(seed)
        want = ck.window_blend_reference(plane.clone(), src, meta)
        before = ck.LAUNCHES["window_blend"]
        got = ck.window_blend(plane.to(cuda), src.to(cuda), meta.to(cuda))
        torch.cuda.synchronize()
        assert ck.LAUNCHES["window_blend"] == before + 1
        assert torch.equal(got.cpu(), want), seed


@pytest.mark.cuda
def test_hybrid_on_the_card_equals_the_cpu(cuda):
    arrays = load_bundle("data/audio_book").to_arrays()
    B, H, W = 3, 300, 520
    rng = np.random.default_rng(6)
    canvases = np.zeros((B, H, W, 4), np.uint8)
    canvases[..., :3] = 90
    canvases[..., 3] = 255
    objs = np.broadcast_to(arrays.objects, (B, *arrays.objects.shape)).copy()
    hw = np.broadcast_to(arrays.obj_hw, (B, *arrays.obj_hw.shape)).copy()
    boxes = np.stack([random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(B)])
    boxes[0, 0] = [40, 20, 40 + 226, 20 + 257]  # an upscale past the envelope
    boxes[1, 1] = [W - 100, H - 50, W + 347, H + 66]  # hangs off the corner
    for form in ({}, {"pipelined": True}, {"clamped": True},
                 {"clamped": True, "pipelined": True}):
        want = ck.composite_batch_hybrid_packed(
            torch.from_numpy(canvases), torch.from_numpy(objs), hw, boxes, **form)
        got = ck.composite_batch_hybrid_packed(
            torch.from_numpy(canvases).to(cuda), torch.from_numpy(objs).to(cuda),
            torch.from_numpy(hw).to(cuda), torch.from_numpy(boxes).to(cuda), **form)
        assert torch.equal(got.cpu(), want), form
    img = torch.from_numpy(objs)
    sizes = (torch.from_numpy(hw[..., 0]), torch.from_numpy(hw[..., 1]))
    out_hw = (torch.from_numpy(boxes[..., 3] - boxes[..., 1]),
              torch.from_numpy(boxes[..., 2] - boxes[..., 0]))
    want = prz.resize_f32(img, sizes, out_hw, (240, 512))
    got = prz.resize_f32(img.to(cuda), tuple(s.to(cuda) for s in sizes),
                         tuple(s.to(cuda) for s in out_hw), (240, 512))
    assert torch.equal(got.cpu(), want)
