"""K4 (the packed window blend, csrc/window_blend.cu) and the hybrid compose
on the card against their plain versions, tolerance 0: the blend is integer
arithmetic, and the producer's resample is the exact float64 one, so the
card and the CPU agree bit for bit. K4's bounds launch alone against its
torch reference (``k4_live_rects_reference``), on packed and planar
sources.

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


def _sources(rng, B, N, mh, mw):
    """Packed sources [B, N, mh, mw]: zero but for a random box of random
    pixels (alpha 0 on some, 255 on others), and on some placements a few
    pixels of nonzero RGB at alpha 0 anywhere (inside the live box or
    outside it); some placements are all zero."""
    src = np.zeros((B, N, mh, mw), np.int32)
    for b in range(B):
        for k in range(N):
            if rng.random() < 0.15:
                continue  # an all-zero source
            r0, c0 = int(rng.integers(0, mh)), int(rng.integers(0, mw))
            r1, c1 = int(rng.integers(r0 + 1, mh + 1)), int(rng.integers(c0 + 1, mw + 1))
            box = rng.integers(-2**31, 2**31, (r1 - r0, c1 - c0), dtype=np.int64).astype(np.int32)
            box[rng.random(box.shape) < 0.3] &= 0x00FFFFFF  # alpha 0
            box[rng.random(box.shape) < 0.2] |= -0x1000000  # alpha 255
            src[b, k, r0:r1, c0:c1] = box
            if rng.random() < 0.5:  # RGB at alpha 0, anywhere in the envelope
                n = int(rng.integers(1, 4))
                src[b, k, rng.integers(0, mh, n), rng.integers(0, mw, n)] = rng.integers(
                    1, 1 << 24, n)
    return src


def live_blend_case(seed):
    """A random plane, sources that are zero outside a live box (see
    ``_sources``) and a meta written directly: origins anywhere, past every
    edge of the plane and off it, odd columns (two placements' edges then
    share a 4-byte word of a planar plane), placements stacked on their
    predecessor's origin give or take a few pixels (overlaps in every
    order), invalid ones, and one invalid with dy == MH. Plane widths and
    source widths that are and are not multiples of 4 and 16."""
    rng = np.random.default_rng(seed)
    B, N = int(rng.integers(1, 4)), int(rng.integers(1, 8))
    mh = int(rng.integers(1, 40))
    mw = int(rng.choice([16, 64, 128, int(rng.integers(1, 90))]))
    hp, wp = int(rng.integers(4, 90)), int(rng.integers(4, 200))
    if rng.random() < 0.6:
        wp = 4 * max(1, wp // 4)
    plane = rng.integers(-2**31, 2**31, (B, hp, wp), dtype=np.int64).astype(np.int32)
    src = _sources(rng, B, N, mh, mw)
    MH = ck.window_extents((mh, mw))[0]
    meta = np.zeros((B, N, 6), np.int32)
    for b in range(B):
        for k in range(N):
            if k > 0 and rng.random() < 0.4:  # stacked on the previous placement
                x = int(meta[b, k - 1, 0] + meta[b, k - 1, 2] + rng.integers(-3, 4))
                y = int(meta[b, k - 1, 1] + meta[b, k - 1, 3] + rng.integers(-3, 4))
            else:
                x, y = int(rng.integers(-mw, wp + 4)), int(rng.integers(-mh, hp + 4))
            ws_x, ws_y = 128 * (x // 128), 8 * (y // 8)
            valid = int(rng.random() < 0.85)
            meta[b, k] = (ws_x, ws_y, x - ws_x, y - ws_y, 0, valid)
        if N > 1 and rng.random() < 0.5:  # dropped, dy == MH as the clamped geometry may give
            meta[b, int(rng.integers(0, N))] = (0, 0, 0, MH, 0, 0)
    return torch.from_numpy(plane), torch.from_numpy(src), torch.from_numpy(meta)


def _planar(packed):
    """A packed int32 [..., H, W] as planar u8 [..., 4, H, W]."""
    return ck.packed_to_u8(packed).movedim(-1, -3).contiguous()


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
def test_k4_matches_plain_version_on_live_boxes(cuda):
    """Sources zero outside a live box (RGB at alpha 0 inside and outside
    it, all-zero sources), origins past every plane edge, stacked and odd
    origins, invalid placements (one with dy == MH)."""
    for seed in range(40):
        plane, src, meta = live_blend_case(seed)
        want = ck.window_blend_reference(plane.clone(), src, meta)
        before = ck.LAUNCHES["window_blend"]
        got = ck.window_blend(plane.to(cuda), src.to(cuda), meta.to(cuda))
        torch.cuda.synchronize()
        assert ck.LAUNCHES["window_blend"] == before + 1
        assert torch.equal(got.cpu(), want), seed


@pytest.mark.cuda
def test_k4_bounds_launch_matches_reference(cuda):
    for seed in range(40):
        plane, src, meta = live_blend_case(200 + seed)
        plane_hw = tuple(plane.shape[1:])
        for s in (src, _planar(src)):
            want = ck.k4_live_rects_reference(s, meta, plane_hw)
            got = ck.k4_live_rects(s.to(cuda), meta.to(cuda), plane_hw)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (seed, s.dim())
    # the producers' outputs: whole 208x384 envelopes of a real bundle
    arrays = load_bundle("data/squarespace").to_arrays()
    rng = np.random.default_rng(3)
    B, H, W = 4, 400, 700
    canvases = torch.zeros((B, H, W, 4), dtype=torch.uint8, device=cuda)
    objs = torch.from_numpy(arrays.objects).to(cuda)[None].expand(B, *arrays.objects.shape)
    hw = torch.from_numpy(np.broadcast_to(arrays.obj_hw, (B, *arrays.obj_hw.shape)).copy())
    boxes = torch.from_numpy(np.stack([random_downscale_boxes(rng, arrays.obj_hw, (H, W))
                                       for _ in range(B)]))
    for producer in (ck._hybrid_producer, ck._hybrid_producer_clamped,
                     ck._hybrid_producer_planar):
        plane, src, meta = producer(canvases, objs, hw.to(cuda), boxes.to(cuda), (208, 384),
                                    "lanczos")
        plane_hw = tuple(plane.shape[-2:])
        want = ck.k4_live_rects_reference(src.cpu(), meta.cpu(), plane_hw)
        assert torch.equal(ck.k4_live_rects(src, meta, plane_hw).cpu(), want)


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
