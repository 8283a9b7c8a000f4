"""K3's gradient form, K2's table stage and mixed launches, and the
gradient render step on the card, against their plain versions, tolerance
0 (all are integer-exact: K3 copies ramp values, K2 builds its tables with
the plain version's op order).

Every test here is marked ``cuda`` and skips without a card:
``python -m pytest tests/test_torch_gradient_step_cuda.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch

from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.parallel import make_gradient_render_step
from tests.test_torch_v3_tables import _campaign


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
    assert ck.LAUNCHES["fused_v3_walks"] == ck.LAUNCHES["fused_v3_chunks"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("level", range(12), ids=[f"level{i:02d}" for i in range(12)])
def test_k2_at_the_uhd_cells_upscales_matches_plain_version(cuda, level):
    """K2's exact-argument tables, built once per placement by its table
    stage, at the cell's own sizes: the bundle's four cutouts at one of the
    12 levels (level 0 the smallest, 2.92x; level 11 the largest, 5.85x) on
    the 2160 x 3840 plane under the cell's envelope, K2 == its plain
    version byte for byte."""
    from image_transformation_tpu_torch.core.bundle import load_bundle

    arrays = load_bundle("bench_torch/bundles/squarespace").to_arrays()
    H, W = 3840, 2160
    hw = arrays.obj_hw
    scale = 5.848394 * np.linspace(0.5, 1.0, 12)
    bounds = [(round(h * scale[-1]), round(w * scale[-1])) for h, w in hw.tolist()]
    sizes = [(round(h * scale[level]), round(w * scale[level])) for h, w in hw.tolist()]
    boxes = np.zeros((1, len(hw), 4), np.int32)
    for k, (h, w) in enumerate(sizes):
        x, y = (W - w) // (k + 2), (H - h) // (k + 2)
        boxes[0, k] = (x, y, x + w, y + h)
    objs_p = ck.planarize_objects(torch.from_numpy(arrays.objects[None]))
    env = (max(h for h, _ in bounds), max(w for _, w in bounds))
    hw_b = hw[None].astype(np.int32)
    want = ck.render_fused_v3_program(objs_p, hw_b, boxes, (H, W), 0x7f102030, env)
    ck.reset_launch_counts()
    got = ck.render_fused_v3_program(objs_p.to(cuda), hw_b, torch.from_numpy(boxes).to(cuda),
                                     (H, W), 0x7f102030, env)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fused_v3_tables"] == 1
    assert ck.LAUNCHES["fused_v3_walks"] == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_k2_walks_each_chunk_of_a_uhd_batch(cuda):
    """B=256 at the UHD cell's pad and envelope runs K2 in 11 chunks of up
    to 25 canvases, each a mixed launch that walks its live tiles. Six
    canvases, first and last ones of chunks, carry the four cutouts at one
    of the cell's levels each (its smallest and its largest among them);
    the other canvases' placements are dropped, so most chunks walk no
    tile. K2 == its plain version on the six, and leaves every other
    canvas of the plane as it was."""
    from image_transformation_tpu_torch.core.bundle import load_bundle

    arrays = load_bundle("bench_torch/bundles/squarespace").to_arrays()
    H, W, B = 3840, 2160, 256
    hw = arrays.obj_hw
    N = len(hw)
    scale = 5.848394 * np.linspace(0.5, 1.0, 12)
    bounds = [(round(h * scale[-1]), round(w * scale[-1])) for h, w in hw.tolist()]
    live = {0: 0, 24: 11, 25: 5, 130: 6, 250: 3, 255: 8}  # canvas: level
    rng = np.random.default_rng(916)
    boxes = np.zeros((B, N, 4), np.int32)
    for b in range(B):
        level = live.get(b, int(rng.integers(0, 12)))
        for k, (h0, w0) in enumerate(hw.tolist()):
            h, w = round(h0 * scale[level]), round(w0 * scale[level])
            x, y = int(rng.integers(0, W - w + 1)), int(rng.integers(0, H - h + 1))
            boxes[b, k] = (x, y, x + w, y + h)
    geo = ck.render_geometry((H, W), (max(h for h, _ in bounds), max(w for _, w in bounds)),
                             N, bounds, pipelined=True)
    env = geo.envelope
    meta = geo.meta(np.broadcast_to(hw, (B, N, 2)).astype(np.int32), boxes, cuda)
    dead = [b for b in range(B) if b not in live]
    meta[dead, :, 5] = 0
    objs_p = ck.planarize_objects(torch.from_numpy(arrays.objects[None]))
    gen = torch.Generator(device=cuda).manual_seed(916)
    before = torch.randint(-2**31, 2**31 - 1, (B, *geo.pad), dtype=torch.int32, device=cuda,
                           generator=gen)
    plane = before.clone()
    ck.reset_launch_counts()
    ck.fused_v3(plane, objs_p.to(cuda), meta, env)
    torch.cuda.synchronize()
    assert env == (1216, 2176) and ck._v3_chunk(B, N, *env, True) == 25
    assert ck.LAUNCHES["fused_v3_chunks"] == ck.LAUNCHES["fused_v3_tables"] == 11
    assert ck.LAUNCHES["fused_v3_walks"] == 11
    for b in live:
        want = ck.fused_v3_reference(before[b:b + 1].cpu(), objs_p, meta[b:b + 1].cpu(), env)
        assert torch.equal(plane[b:b + 1].cpu(), want), b
    assert all(torch.equal(plane[b], before[b]) for b in dead)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["score916", "in_1", "out_in_plus_1", "in_at_pad",
                                  "out_clamped", "dropped_and_same"])
def test_k2_table_stage_matches_plain_version(cuda, case):
    """The stage alone on the CPU tests' campaigns: every entry (taps, lo,
    hi, and 0 where it writes nothing) == its plain version."""
    meta, pad, env = _campaign(case)
    want = ck.fused_v3_tables_reference(meta, pad, env)
    got = ck.fused_v3_tables(meta.to(cuda), pad, env)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_k2_mixed_launch_with_a_growing_and_a_shrinking_axis_matches_plain_version(cuda):
    """In a mixed launch (the envelope past the pad) placements that grow
    on one axis and shrink on the other (tiles that load one axis's entries
    and build the other's), grow on both, shrink on both, and a dropped and
    a plain-copy placement, soft alpha: K2 == its plain version."""
    rng = np.random.default_rng(5)
    B, N, ph, pw = 3, 5, 48, 256
    env = (200, 384)
    objs = torch.from_numpy(rng.integers(0, 256, (1, N, 4, ph, pw), dtype=np.uint8))
    meta = np.zeros((B, N, 10), np.int32)
    #          in_h in_w out_h out_w (h grows & w shrinks, h shrinks & w grows, both grow,
    #          both shrink, a plain copy)
    sizes = [(40, 250, 190, 97), (47, 120, 31, 383), (13, 17, 150, 300), (48, 256, 20, 70),
             (30, 60, 30, 60)]
    for b in range(B):
        for k, (ih, iw, oh, ow) in enumerate(sizes):
            meta[b, k] = (128 * (k % 2), 8 * k, 3 * k, k, int(k == 4), int(b != 1 or k != 2),
                          ih, iw, oh, ow)
    meta = torch.from_numpy(meta)
    plane = torch.from_numpy(_ints(rng, (B, 400, 640)))
    want = ck.fused_v3_reference(plane.clone(), objs, meta, env)
    ck.reset_launch_counts()
    got = ck.fused_v3(plane.to(cuda), objs.to(cuda), meta.to(cuda), env)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fused_v3_tables"] == ck.LAUNCHES["fused_v3_walks"] == 1
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
    assert ck._v3_chunk(B, N, *env, True) == chunk  # the table buffer fits beside it
    ck.reset_launch_counts()
    ck.fused_v3(plane, objs_p, meta, env)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fused_v3"] == 1
    assert ck.LAUNCHES["fused_v3_chunks"] == -(-B // chunk) == 3
    assert ck.LAUNCHES["fused_v3_tables"] == 3  # a mixed launch: one table stage a chunk
    assert ck.LAUNCHES["fused_v3_walks"] == 3  # each chunk walks its (no) live tiles
    assert bool((plane == 7).all())
    # an envelope within the pad shrinks only: no table stage
    ck.fused_v3(plane, objs_p, meta, (8, 128))
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fused_v3_chunks"] == 4 and ck.LAUNCHES["fused_v3_tables"] == 3
    assert ck.LAUNCHES["fused_v3_walks"] == 4
    assert bool((plane == 7).all())
