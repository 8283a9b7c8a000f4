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
