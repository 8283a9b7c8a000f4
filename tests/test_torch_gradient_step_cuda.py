"""K3's gradient form and the gradient render step on the card, against
their plain versions, tolerance 0 (both are integer-exact: K3 copies ramp
values, K2 builds its tables with the plain version's op order).

Every test here is marked ``cuda`` and skips without a card:
``python -m pytest tests/test_torch_gradient_step_cuda.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch

from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.parallel import make_gradient_render_step


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 and K3 have no CPU mode")
    return torch.device("cuda", 0)


def _ints(rng, shape):
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("horizontal", [True, False], ids=["horizontal", "vertical"])
def test_k3_ramp_form_matches_plain_version_at_cut_windows(cuda, horizontal):
    """Windows past every edge of the plane, overlapping, narrower than a
    16-byte group, and at the UHD cell's size; a plane whose rows do not
    start on 16 bytes (an offset view) for the unaligned groups."""
    rng = np.random.default_rng(11)
    for B, N, hp, wp, top in ((3, 6, 64, 384, 80), (2, 4, 3840, 2304, 2400), (4, 40, 96, 260, 90)):
        plane = torch.from_numpy(_ints(rng, (B, hp, wp)))
        n = wp if horizontal else hp
        ramp = ck.GradientRamp(torch.from_numpy(_ints(rng, n)), horizontal)
        ext = tuple((int(h), int(w)) for h, w in zip(rng.integers(1, top, N),
                                                    rng.integers(1, top, N)))
        origins = rng.integers(-top, max(hp, wp) + 8, (B, N, 2)).astype(np.int32)
        origins[0, 0] = (wp - 2, hp - 3)
        origins[-1, -1] = (-5, -9)
        origins = torch.from_numpy(origins)
        want = ck.restore_windows_reference(plane.clone(), origins, ext, ramp)
        got = ck.restore_windows(plane.to(cuda), origins.to(cuda), ext,
                                 ck.GradientRamp(ramp.values.to(cuda), horizontal))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (B, N, hp, wp)
    # rows that start 4 bytes past a 16-byte boundary
    base = torch.from_numpy(_ints(rng, (2 * 64 * 260 + 1,)))
    plane = base[1:].view(2, 64, 260)
    ramp = ck.GradientRamp(torch.from_numpy(_ints(rng, 260 if horizontal else 64)), horizontal)
    origins = torch.from_numpy(rng.integers(-20, 250, (2, 5, 2)).astype(np.int32))
    ext = ((30, 101), (7, 3), (64, 260), (1, 1), (12, 40))
    want = ck.restore_windows_reference(plane.clone(), origins, ext, ramp)
    dev_base = base.to(cuda)
    got = ck.restore_windows(dev_base[1:].view(2, 64, 260), origins.to(cuda), ext,
                             ck.GradientRamp(ramp.values.to(cuda), horizontal))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("horizontal", [True, False], ids=["horizontal", "vertical"])
def test_gradient_step_with_upscales_matches_the_cpu_step(cuda, horizontal):
    """A chain of reuse steps at 640 x 384, objects up to 40 x 60 at 1-4x
    (soft and binary alpha), the card's planes and lumas == the CPU's."""
    rng = np.random.default_rng(21)
    H, W, B, N = 640, 384, 6, 4
    hw = np.array([[40, 60], [25, 44], [33, 18], [12, 50]])
    objs = np.zeros((1, N, 40, 60, 4), np.uint8)
    for k, (h, w) in enumerate(hw):
        px = rng.integers(0, 256, (h, w, 4))
        if k % 2:
            px[..., 3] = np.where(px[..., 3] > 100, 255, 0)
        objs[0, k, :h, :w] = px
    bounds = tuple((4 * int(h), 4 * int(w)) for h, w in hw)
    spec = ((201, 33, 70), (18, 240, 121), horizontal)
    steps = {dev: make_gradient_render_step((H, W), bounds, spec, device=str(dev))
             for dev in ("cpu", cuda)}
    hw_b = np.broadcast_to(hw, (B, N, 2)).astype(np.int32)
    ck.reset_launch_counts()
    for _ in range(3):
        boxes = np.zeros((B, N, 4), np.int32)
        for b in range(B):
            for k, (h, w) in enumerate(hw):
                s = rng.uniform(1.0, 4.0)
                bw, bh = max(1, round(w * s)), max(1, round(h * s))
                x, y = rng.integers(0, W - bw + 1), rng.integers(0, H - bh + 1)
                boxes[b, k] = (x, y, x + bw, y + bh)
        out = {dev: step(None, objs, hw_b, boxes) for dev, step in steps.items()}
        torch.cuda.synchronize()
        assert torch.equal(out[cuda][0].cpu(), out["cpu"][0])
        assert torch.equal(out[cuda][1].cpu(), out["cpu"][1])
    assert ck.LAUNCHES["restore_windows"] == 2 and ck.LAUNCHES["fused_v3"] == 3


@pytest.mark.cuda
def test_k2_at_the_uhd_cells_upscales_matches_plain_version(cuda):
    """K2's exact-argument tables at the cell's own sizes: the bundle's four
    cutouts at the largest of the 12 levels and at the smallest, on the
    2160 x 3840 plane, K2 == its plain version byte for byte."""
    from image_transformation_tpu_torch.core.bundle import load_bundle

    arrays = load_bundle("bench_torch/bundles/squarespace").to_arrays()
    H, W = 3840, 2160
    hw = arrays.obj_hw
    bounds = [(round(h * 5.848394), round(w * 5.848394)) for h, w in hw.tolist()]
    small = [(round(h * 2.924197), round(w * 2.924197)) for h, w in hw.tolist()]
    boxes = np.zeros((2, len(hw), 4), np.int32)
    for b, sizes in enumerate((bounds, small)):
        for k, (h, w) in enumerate(sizes):
            x, y = (W - w) // (k + 2), (H - h) // (k + 2)
            boxes[b, k] = (x, y, x + w, y + h)
    objs_p = ck.planarize_objects(torch.from_numpy(arrays.objects[None]))
    env = (max(h for h, _ in bounds), max(w for _, w in bounds))
    hw_b = np.broadcast_to(hw, (2, *hw.shape)).astype(np.int32)
    want = ck.render_fused_v3_program(objs_p, hw_b, boxes, (H, W), 0x7f102030, env)
    got = ck.render_fused_v3_program(objs_p.to(cuda), hw_b, torch.from_numpy(boxes).to(cuda),
                                     (H, W), 0x7f102030, env)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_k2_chunk_counter_counts_each_chunk_of_an_overflowing_batch(cuda):
    """At the UHD cell's envelope (1216 x 2176, N = 4) one canvas takes 42 MB
    of K2's scratch, so 25 fit its 1 GiB and a batch of 60 runs in 3 chunks:
    one call, three chunk launches. Placements are not valid, so nothing is
    drawn and the plane stays as it was."""
    B, N, env = 60, 4, (1216, 2176)
    per = N * 4 * env[0] * env[1]
    chunk = ck._V3_SCRATCH_BYTES // per
    assert chunk == 25
    plane = torch.full((B, 8, 128), 7, dtype=torch.int32, device=cuda)
    objs_p = torch.zeros((1, N, 4, 8, 128), dtype=torch.uint8, device=cuda)
    meta = torch.zeros((B, N, 10), dtype=torch.int32, device=cuda)
    ck.reset_launch_counts()
    ck.fused_v3(plane, objs_p, meta, env)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fused_v3"] == 1
    assert ck.LAUNCHES["fused_v3_chunks"] == -(-B // chunk) == 3
    assert bool((plane == 7).all())
