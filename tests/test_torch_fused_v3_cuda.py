"""K2 (gen-3 fused) and K3 (window restore) on the card against their plain
versions, tolerance 0 (both are integer-exact given the same f32 tables,
and the kernel builds its tables with the plain version's op order).

Every test here is marked ``cuda`` and skips without a card:
``python -m pytest tests/test_torch_fused_v3_cuda.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch

from image_transformation_tpu_torch.ops import compose_kernels as ck


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 and K3 have no CPU mode")
    return torch.device("cuda", 0)


def _fuzz_case(seed):
    """Random planar objects (random alpha), envelope, canvas and boxes:
    downscales, upscales past the envelope (clamped), identity sizes, 1 px,
    edge overhangs and dropped origins; shared or per-canvas objects."""
    rng = np.random.default_rng(seed)
    B, N = int(rng.integers(1, 4)), int(rng.integers(1, 6))
    ph, pw = (int(v) for v in rng.integers(3, 150, 2))
    H, W = int(rng.integers(8, 300)), int(rng.integers(8, 400))
    shared = bool(rng.integers(0, 2))
    Bo = 1 if shared else B
    objs = rng.integers(0, 256, (Bo, N, ph, pw, 4), dtype=np.uint8)
    hw_row = np.stack([rng.integers(1, ph + 1, N), rng.integers(1, pw + 1, N)], -1)
    for k in range(N):
        objs[:, k, hw_row[k, 0]:] = 0
        objs[:, k, :, hw_row[k, 1]:] = 0
    hw = np.broadcast_to(hw_row, (B, N, 2)).copy()
    boxes = np.zeros((B, N, 4), np.int64)
    for b in range(B):
        for k in range(N):
            oh, ow = (int(v) for v in hw_row[k])
            mode = int(rng.integers(0, 5))
            if mode == 0:
                bh, bw = oh, ow
            elif mode == 1:
                bh, bw = 1, 1
            elif mode == 2:
                bh, bw = int(rng.integers(1, 3 * ph)), int(rng.integers(1, 3 * pw))
            else:
                s = float(rng.uniform(0.1, 1.0))
                bh, bw = max(1, int(oh * s)), max(1, int(ow * s))
            x1, y1 = int(rng.integers(-5, W + 3)), int(rng.integers(-5, H + 3))
            boxes[b, k] = (x1, y1, x1 + bw, y1 + bh)
    static = tuple((int(h), int(w)) for h, w in hw_row) if rng.integers(0, 2) else None
    return objs, hw, boxes, (H, W), static


@pytest.mark.cuda
def test_k2_matches_plain_version_on_random_geometries(cuda):
    for seed in range(30):
        objs, hw, boxes, canvas_hw, static = _fuzz_case(seed)
        op = ck.planarize_objects(torch.from_numpy(objs))
        bg = ck.pack_rgba_scalar((30 + seed, 200, 90, 255 if seed % 3 else 120))
        plain = ck.render_solid_fused_v3_program(
            op, hw, boxes, canvas_hw, bg, pipelined=True, static_obj_hw=static
        )
        before = ck.LAUNCHES["fused_v3"]
        got = ck.render_solid_fused_v3_program(
            op.to(cuda), hw, torch.from_numpy(boxes).to(cuda), canvas_hw, bg,
            pipelined=True, static_obj_hw=static,
        )
        torch.cuda.synchronize()
        assert ck.LAUNCHES["fused_v3"] == before + 1
        assert torch.equal(got.cpu(), plain), seed


@pytest.mark.cuda
def test_k3_and_reuse_chain_match_plain_version(cuda):
    for seed in range(10):
        objs, hw, _, canvas_hw, static = _fuzz_case(100 + seed)
        rng = np.random.default_rng(seed)
        H, W = canvas_hw
        B, N = hw.shape[:2]
        op = ck.planarize_objects(torch.from_numpy(objs))
        bg = ck.pack_rgba_scalar((12, 34, 56, 255))

        def boxes():
            s = rng.uniform(0.2, 1.0, (B, N, 1))
            wh = np.maximum(1, (hw[..., ::-1] * s).astype(np.int64))
            xy = np.stack([rng.integers(0, W, (B, N)), rng.integers(0, H, (B, N))], -1)
            return np.concatenate([xy, xy + wh], -1)

        sets = [boxes() for _ in range(4)]
        planes = {}
        for dev in ("cpu", cuda):
            plane = ck.render_solid_fused_v3_program(
                op.to(dev), hw, torch.from_numpy(sets[0]).to(dev), canvas_hw, bg,
                pipelined=True, static_obj_hw=static,
            )
            for prev, cur in zip(sets, sets[1:]):
                plane = ck.render_solid_fused_v3_reuse_program(
                    plane, torch.from_numpy(prev).to(dev), op.to(dev), hw,
                    torch.from_numpy(cur).to(dev), canvas_hw, bg,
                    static_obj_hw=static, pipelined=True,
                )
            planes[str(dev)] = plane.cpu()
        assert torch.equal(planes["cpu"], planes[str(cuda)]), seed
        fresh = ck.render_solid_fused_v3_program(
            op, hw, sets[-1], canvas_hw, bg, pipelined=True, static_obj_hw=static
        )
        assert torch.equal(planes["cpu"], fresh), seed

        # the restore alone, on a random plane with random windows
        plane = torch.from_numpy(
            rng.integers(-2**31, 2**31, (B, 40, 300), dtype=np.int64).astype(np.int32)
        )
        origins = torch.from_numpy(
            np.stack([rng.integers(-20, 300, (B, N)), rng.integers(-10, 40, (B, N))], -1)
            .astype(np.int32)
        )
        extents = [(int(rng.integers(1, 30)), int(rng.integers(1, 260))) for _ in range(N)]
        want = ck.restore_windows_reference(plane.clone(), origins, extents, bg)
        before = ck.LAUNCHES["restore_windows"]
        got = ck.restore_windows(plane.to(cuda), origins.to(cuda), extents, bg)
        torch.cuda.synchronize()
        assert ck.LAUNCHES["restore_windows"] == before + 1
        assert torch.equal(got.cpu(), want), seed


@pytest.mark.cuda
def test_k3_overlapping_narrow_and_edge_windows_match_plain_version(cuda):
    """Windows that overlap (stacked on their predecessor give or take a few
    pixels), 1-3 px wide, at odd columns (16-byte groups cut at both ends),
    past each edge of the plane and off it; plane widths off multiples of 4
    (rows that start off 16-byte boundaries)."""
    for seed in range(30):
        rng = np.random.default_rng(500 + seed)
        B, N = int(rng.integers(1, 5)), int(rng.integers(1, 9))
        hp, wp = int(rng.integers(1, 60)), int(rng.integers(1, 300))
        plane = torch.from_numpy(
            rng.integers(-2**31, 2**31, (B, hp, wp), dtype=np.int64).astype(np.int32))
        ext = [(int(rng.integers(1, 40)), int(rng.choice([1, 2, 3, int(rng.integers(1, 200))])))
               for _ in range(N)]
        xy = np.zeros((B, N, 2), np.int32)
        for b in range(B):
            for k in range(N):
                if k and rng.random() < 0.4:
                    xy[b, k] = xy[b, k - 1] + rng.integers(-3, 4, 2)
                else:
                    xy[b, k] = (rng.integers(-60, wp + 5), rng.integers(-20, hp + 5))
        origins = torch.from_numpy(xy)
        bg = int(rng.integers(-2**31, 2**31))
        want = ck.restore_windows_reference(plane.clone(), origins, ext, bg)
        got = ck.restore_windows(plane.to(cuda), origins.to(cuda), tuple(ext), bg)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), seed
        # a list of pairs (not cached: its tuple is) gives the same
        got = ck.restore_windows(plane.to(cuda), origins.to(cuda), ext, bg)
        assert torch.equal(got.cpu(), want), seed


@pytest.mark.cuda
def test_k2_chunked_windows_and_overlaps_match_plain_version(cuda):
    """Pads up to 300x420, so 1-px boxes (windows spanning the whole
    source) and steep downscales walk the source patch in chunks of rows
    and columns; every placement of canvas 0 at one origin (z-order)."""
    for seed in range(8):
        rng = np.random.default_rng(700 + seed)
        B, N = int(rng.integers(1, 3)), int(rng.integers(2, 5))
        ph, pw = int(rng.integers(64, 300)), int(rng.integers(129, 420))
        H, W = int(rng.integers(64, 400)), int(rng.integers(64, 600))
        objs = rng.integers(0, 256, (1, N, ph, pw, 4), dtype=np.uint8)
        hw_row = np.stack([rng.integers(ph // 2, ph + 1, N), rng.integers(pw // 2, pw + 1, N)], -1)
        for k in range(N):
            objs[:, k, hw_row[k, 0]:] = 0
            objs[:, k, :, hw_row[k, 1]:] = 0
        hw = np.broadcast_to(hw_row, (B, N, 2)).copy()
        boxes = np.zeros((B, N, 4), np.int64)
        for b in range(B):
            for k in range(N):
                oh, ow = (int(v) for v in hw_row[k])
                bh, bw = [(1, 1), (oh, ow), (max(1, oh // 9), max(1, ow // 7)),
                          (int(rng.integers(1, oh + 1)), int(rng.integers(1, ow + 1)))][
                    int(rng.integers(0, 4))]
                x1, y1 = (3, 2) if b == 0 else (int(rng.integers(-5, W)), int(rng.integers(-5, H)))
                boxes[b, k] = (x1, y1, x1 + bw, y1 + bh)
        op = ck.planarize_objects(torch.from_numpy(objs))
        bg = ck.pack_rgba_scalar((40, 60, 200, 255 if seed % 2 else 100))
        plain = ck.render_solid_fused_v3_program(op, hw, boxes, (H, W), bg, pipelined=False)
        got = ck.render_solid_fused_v3_program(
            op.to(cuda), hw, torch.from_numpy(boxes).to(cuda), (H, W), bg, pipelined=False)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), plain), seed


@pytest.mark.cuda
def test_k2_pads_past_the_staged_taps_match_plain_version(cuda):
    """Objects padded to 4000x3600: the tiles' compact tap arrays do not fit
    beside the resample core (ph + pw > 7,456), so every tile computes each
    tap where it uses it. A 1-px box (one window spanning the whole
    source), a steep downscale overlapping it, and an identity copy."""
    rng = np.random.default_rng(11)
    ph, pw, mh, mw = 4000, 3600, 64, 128
    objs = torch.from_numpy(rng.integers(0, 256, (1, 3, 4, ph, pw), dtype=np.uint8)).to(cuda)
    # ws_x ws_y dx dy same valid in_h in_w out_h out_w
    meta = torch.tensor([[[0, 0, 5, 3, 0, 1, ph, pw, 1, 1],
                          [0, 0, 2, 1, 0, 1, 3999, 3517, 60, 50],
                          [128, 8, 7, 0, 1, 1, 40, 90, 40, 90]]],
                        dtype=torch.int32, device=cuda)
    plane = torch.from_numpy(
        rng.integers(-2**31, 2**31, (1, 96, 384), dtype=np.int64).astype(np.int32)).to(cuda)
    want = ck.fused_v3_reference(plane.clone(), objs, meta, (mh, mw))
    before = ck.LAUNCHES["fused_v3"]
    got = ck.fused_v3(plane.clone(), objs, meta, (mh, mw))
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fused_v3"] == before + 1
    assert not torch.equal(got, plane)
    assert torch.equal(got, want)
