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


def _walk_case(name):
    """(objects u8 [Bo, N, 4, ph, pw], meta i32 [B, N, 10], plane i32 [B, hp,
    wp], envelope) of one edge of K2's live-tile walk; origins overlap
    (z-order), and boxes pass the plane's right and bottom edges (a
    negative origin is outside K2's contract: the meta never gives one)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    ph, pw, env, hp, wp = 48, 128, (96, 160), 160, 256
    if name == "all_dropped":  # a chunk of 0 live tiles: nothing drawn
        sizes, valid, same, B = [(40, 100, 90, 150)] * 4, 0, 0, 3
    elif name == "fills_the_envelope":  # one placement's tiles are the envelope's
        sizes, valid, same, B = [(40, 100, 96, 160), (20, 30, 9, 7)], 1, 0, 2
    elif name in ("edge_sizes", "edge_sizes_in_the_pad"):  # out of 1, 31, 32, 33 an axis
        sizes = [(30, 60, h, w) for h in (1, 31, 32, 33) for w in (1, 31, 32, 33)]
        valid, same, B = 1, 0, 2
        if name == "edge_sizes_in_the_pad":  # the shrinking instance: no table stage
            env = (ph, pw)
    elif name == "plain_copy":  # `same` placements copy their pixels, beside a resample
        sizes, valid, same, B = [(40, 90, 40, 90), (33, 70, 50, 140), (9, 31, 9, 31)], 1, 1, 2
    elif name == "per_canvas_objects":  # Bo == B
        sizes, valid, same, B = [(40, 100, 70, 33), (17, 128, 96, 64), (48, 10, 5, 159)], 1, 0, 3
    else:
        raise KeyError(name)
    N = len(sizes)
    Bo = B if name == "per_canvas_objects" else 1
    objs = torch.from_numpy(rng.integers(0, 256, (Bo, N, 4, ph, pw), dtype=np.uint8))
    meta = np.zeros((B, N, 10), np.int32)
    for b in range(B):
        for k, (ih, iw, oh, ow) in enumerate(sizes):
            x, y = int(rng.integers(0, wp - 10)), int(rng.integers(0, hp - 10))
            meta[b, k] = (x, y, 0, 0, same and k % 2 == 0, valid, ih, iw, oh, ow)
    plane = torch.from_numpy(
        rng.integers(-2**31, 2**31, (B, hp, wp), dtype=np.int64).astype(np.int32))
    return objs, torch.from_numpy(meta), plane, env


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_dropped", "fills_the_envelope", "edge_sizes",
                                  "edge_sizes_in_the_pad", "plain_copy", "per_canvas_objects"])
def test_k2_walk_edges_match_plain_version(cuda, case):
    """Each edge of the live-tile walk, in one chunk of one walk a kernel:
    K2 == its plain version byte for byte, on a grid of at most the SMs
    times the resident blocks, and no more blocks than a grid over the
    envelope would take."""
    objs, meta, plane, env = _walk_case(case)
    B, N = meta.shape[:2]
    want = ck.fused_v3_reference(plane.clone(), objs, meta, env)
    ck.reset_launch_counts()
    got = ck.fused_v3(plane.to(cuda), objs.to(cuda), meta.to(cuda), env)
    torch.cuda.synchronize()
    grid = ck._v3_grid(B, N, objs.shape[3:], env, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    envelope_blocks = B * N * -(-env[0] // 32) * -(-env[1] // 32)
    assert grid.resample_launches == grid.blend_launches == 1
    assert ck.LAUNCHES["fused_v3_walks"] == ck.LAUNCHES["fused_v3_chunks"] == 1
    assert grid.resample_resident >= 1 and grid.blend_resident >= 1
    assert grid.resample_blocks == min(sms * grid.resample_resident, envelope_blocks)
    assert grid.blend_blocks == min(sms * grid.blend_resident, envelope_blocks)
    assert torch.equal(got.cpu(), want)
    if case == "all_dropped":
        assert torch.equal(got.cpu(), plane)
    else:
        assert not torch.equal(got.cpu(), plane)


@pytest.mark.cuda
@pytest.mark.parametrize("env", [(32, 32), (96, 160)], ids=["shrinking", "mixed"])
def test_k2_past_the_walks_prefix_cap_splits_the_launch(cuda, env):
    """B*N = 21,000 placements: the walk's prefix (84 KB) does not fit
    beside the resample's shared memory at its resident blocks, so each
    kernel walks consecutive ranges of at most its cap of placements, in
    several launches, every resample before the first blend; a range may
    end inside a canvas. K2 == its plain version on the canvases at each
    range's ends and on the first and the last; the rest are dropped and
    stay as they were."""
    rng = np.random.default_rng(21000)
    B, N, ph, pw = 3000, 7, 48, 128
    chunk = ck._v3_chunk(B, N, *env, env[0] > ph or env[1] > pw)
    ends, walks = {0, B - 1}, 0
    for b0 in range(0, B, chunk):
        n = min(chunk, B - b0) * N
        grid = ck._v3_grid(n // N, N, (ph, pw), env, cuda)
        assert grid.resample_launches == -(-n // grid.resample_cap)
        assert grid.blend_launches == -(-n // grid.blend_cap)
        if b0 == 0:
            assert grid.resample_launches > 1 and grid.blend_launches > 1
        walks += grid.resample_launches
        ends |= {b0 + p // N for cap in (grid.resample_cap, grid.blend_cap)
                 for p0 in range(cap, n, cap) for p in (p0 - 1, p0)}
    live = sorted(ends)
    objs = torch.from_numpy(rng.integers(0, 256, (1, N, 4, ph, pw), dtype=np.uint8))
    meta = np.zeros((B, N, 10), np.int32)
    for b in live:
        for k in range(N):
            oh, ow = 32 - 4 * k, 31 + 10 * k  # past a small envelope: clamped
            meta[b, k] = (8 * k, 4 * k, 0, 0, int(k == 3), 1, 40, 100, oh, ow)
    meta = torch.from_numpy(meta)
    plane = torch.from_numpy(
        rng.integers(-2**31, 2**31, (B, 48, 128), dtype=np.int64).astype(np.int32))
    ck.reset_launch_counts()
    got = ck.fused_v3(plane.to(cuda), objs.to(cuda), meta.to(cuda), env).cpu()
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fused_v3_chunks"] == -(-B // chunk)
    assert ck.LAUNCHES["fused_v3_walks"] == walks > ck.LAUNCHES["fused_v3_chunks"]
    idx = torch.tensor(live)
    want = ck.fused_v3_reference(plane[idx].clone(), objs, meta[idx], env)
    assert torch.equal(got[idx], want)
    dead = torch.ones(B, dtype=torch.bool)
    dead[idx] = False
    assert torch.equal(got[dead], plane[dead])
    assert not torch.equal(got[idx], plane[idx])


@pytest.mark.cuda
def test_k2_walk_at_the_score1080_shapes_matches_plain_version(cuda):
    """The score1080 cell's launch: 1080 wide x 1920 high, B=256, the
    bundle's four cutouts shrunk by U(0.3, 1.0) at uniform origins (the
    shrinking instance, one chunk of 1,024 placements): K2 walks and ==
    its plain version."""
    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.parallel.sweep import random_downscale_boxes

    arrays = load_bundle("data/squarespace").to_arrays()
    H, W, B = 1920, 1080, 256
    N = arrays.obj_hw.shape[0]
    rng = np.random.default_rng(1080)
    boxes = np.stack([random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(B)])
    hw = np.broadcast_to(arrays.obj_hw, (B, N, 2)).astype(np.int32)
    op = ck.planarize_objects(torch.from_numpy(arrays.objects[None]))
    static = tuple(tuple(int(v) for v in row) for row in arrays.obj_hw)
    bg = ck.pack_rgba_scalar((128, 128, 128, 255))
    want = ck.render_solid_fused_v3_program(op, hw, boxes, (H, W), bg, pipelined=True,
                                            static_obj_hw=static)
    ck.reset_launch_counts()
    got = ck.render_solid_fused_v3_program(op.to(cuda), hw, torch.from_numpy(boxes).to(cuda),
                                           (H, W), bg, pipelined=True, static_obj_hw=static)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fused_v3_chunks"] == ck.LAUNCHES["fused_v3_walks"] == 1
    assert ck.LAUNCHES["fused_v3_tables"] == 0  # the envelope is the objects' pad
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_k2_walk_claims_stay_right_across_launches_and_streams(cuda):
    """The resample's walk claims tiles from a counter kept per device and
    stream (``compose_kernels._v3_claims``), which each launch's last block
    zeroes: launches in turn on the default stream and on a side stream,
    and a launch of another shape between them, each == the plain version;
    the counters are zero after them."""
    objs, meta, plane, env = _walk_case("per_canvas_objects")
    want = ck.fused_v3_reference(plane.clone(), objs, meta, env)
    o2, m2, p2, e2 = _walk_case("edge_sizes")
    want2 = ck.fused_v3_reference(p2.clone(), o2, m2, e2)
    objs, meta, plane = objs.to(cuda), meta.to(cuda), plane.to(cuda)
    o2, m2, p2 = o2.to(cuda), m2.to(cuda), p2.to(cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))  # the inputs are copied on the default
    outs = []
    for on_side in (False, True, False, True):
        with torch.cuda.stream(side if on_side else torch.cuda.current_stream(cuda)):
            outs.append(ck.fused_v3(plane.clone(), objs, meta, env))
            outs.append(ck.fused_v3(p2.clone(), o2, m2, e2))
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        assert torch.equal(got.cpu(), want2 if i % 2 else want), i
    for stream in (torch.cuda.current_stream(cuda), side):
        assert ck._v3_claims(torch.device(cuda), stream.cuda_stream).tolist() == [0, 0]


@pytest.mark.cuda
def test_k2_walk_replays_in_a_cuda_graph(cuda):
    """K2 captured into a CUDA graph, after a launch outside it: the
    captured launch takes its claim counter from the graph's memory, and
    each replay == the plain version (the counter is zero again for the
    next replay)."""
    objs, meta, plane, env = _walk_case("per_canvas_objects")
    want = ck.fused_v3_reference(plane.clone(), objs, meta, env)
    objs, meta, plane = objs.to(cuda), meta.to(cuda), plane.to(cuda)
    work = plane.clone()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):  # warm up outside the capture: the library, the caches
        ck.fused_v3(work, objs, meta, env)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ck.fused_v3(work, objs, meta, env)
    for _ in range(3):
        work.copy_(plane)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(work.cpu(), want)


def _tile_spans(n_in: int, n_out: int) -> torch.Tensor:
    """Source positions each 32-wide tile of one axis reads: the span of
    the union of its output positions' non-empty windows (0 where all are
    empty), as a mixed K2 launch's tiles take them (exact-argument windows
    where the axis grows, the f32 form's where it does not)."""
    from image_transformation_tpu_torch.ops.resize import _grows, row_windows, upscale_tap_windows

    n = -(-n_out // 32) * 32
    n_in, n_out = torch.tensor(n_in), torch.tensor(n_out)
    if bool(_grows(n_in, n_out)):
        lo, hi, _ = upscale_tap_windows(n_in, n_out, n)
    else:
        lo, hi = row_windows(n_in, n_out, n).unbind(-1)
    lo, hi = lo.reshape(-1, 32), hi.reshape(-1, 32)
    live = hi > lo
    top = torch.where(live, hi, 0).amax(1)
    bottom = torch.where(live, lo, torch.iinfo(torch.int64).max).amin(1)
    return torch.where(live.any(1), top - bottom, 0)


def _h_pass_forms(meta, pad, env):
    """(tiles whose H pass takes the column form, tiles resampled) of a
    mixed K2 launch: the column form where a tile's rows read fewer than 32
    source rows and its columns at most 128 source columns (one chunk of
    rows, one patch: csrc/resample.cuh)."""
    (ph, pw), (mh, mw) = pad, env
    cols = total = 0
    for row in meta.reshape(-1, 10).tolist():
        in_h, in_w = min(max(row[6], 0), ph), min(max(row[7], 0), pw)
        out_h, out_w = min(max(row[8], 0), mh), min(max(row[9], 0), mw)
        if row[5] <= 0 or row[4] > 0 or out_h == 0 or out_w == 0:
            continue  # dropped, or a plain copy
        narrow = _tile_spans(in_w, out_w) <= 128
        short = _tile_spans(in_h, out_h) < 32
        cols += int((short[:, None] & narrow[None, :]).sum())
        total += short.numel() * narrow.numel()
    return cols, total


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 16, 17, 24, 31, 32, 33])
def test_k2_mixed_h_pass_forms_match_plain_version(cuda, rows):
    """The mixed instance's two H-pass forms: every placement's vertical
    axis grows so that its first tile reads `rows` source rows (the column
    form below 32, the row form from 32 on), to 100 output rows (a partial
    bottom tile), beside a growing, a shrinking (windows past the column
    form's 6 register taps) and a steeply shrinking horizontal axis (a wide
    tile: the row form at any row count); per-canvas objects (Bo == B) with
    an empty slot. K2 == its plain version byte for byte, and the tally
    counts each tile's form."""
    rng = np.random.default_rng(rows)
    B, N, ph, pw, env, hp, wp = 2, 4, 96, 160, (128, 160), 320, 480
    out_h = 100
    in_h = next(i for i in range(1, out_h) if int(_tile_spans(i, out_h)[0]) == rows)
    widths = [(37, 130), (150, 61), (150, 20), (37, 130)]  # (in_w, out_w) of each slot
    objs = torch.from_numpy(rng.integers(0, 256, (B, N, 4, ph, pw), dtype=np.uint8))
    meta = np.zeros((B, N, 10), np.int32)
    for b in range(B):
        for k, (in_w, out_w) in enumerate(widths):
            x, y = int(rng.integers(0, wp - 40)), int(rng.integers(0, hp - 40))
            meta[b, k] = (x, y, 0, 0, 0, 1, in_h, in_w, out_h, out_w)
    meta[1, 3] = (wp, hp, 0, 0, 0, 0, 0, 0, 0, 0)  # canvas 1's empty slot
    meta = torch.from_numpy(meta)
    plane = torch.from_numpy(
        rng.integers(-2**31, 2**31, (B, hp, wp), dtype=np.int64).astype(np.int32))
    cols, total = _h_pass_forms(meta, (ph, pw), env)
    assert total == 4 * (2 * (5 + 2 + 1) + 5)  # 4 tile rows; 5, 2 and 1 tile columns a slot
    assert 0 < cols < total  # the last tile row reads 1-6 rows; the wide slot keeps rows
    want = ck.fused_v3_reference(plane.clone(), objs, meta, env)
    before = ck.fused_v3_h_tally(cuda)
    got = ck.fused_v3(plane.to(cuda), objs.to(cuda), meta.to(cuda), env)
    after = ck.fused_v3_h_tally(cuda)
    assert torch.equal(got.cpu(), want)
    assert (after[0] - before[0], after[1] - before[1]) == (cols, total)


@pytest.mark.cuda
def test_k2_h_pass_tally_at_the_score916_and_score1080_shapes(cuda):
    """At the UHD cell's shapes (the bundle's four cutouts at each of its 12
    levels, 2.92-5.85x, on the 2160 x 3840 plane under its envelope) the
    mixed instance's H pass takes the column form on at least 95% of the
    resampled tiles, as the windows predict; score1080's downscales (the
    other instance) add nothing to the tally."""
    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.parallel.sweep import random_downscale_boxes

    arrays = load_bundle("bench_torch/bundles/squarespace").to_arrays()
    H, W, B = 3840, 2160, 12
    hw = arrays.obj_hw
    N = len(hw)
    scale = 5.848394 * np.linspace(0.5, 1.0, 12)
    bounds = [(round(h * scale[-1]), round(w * scale[-1])) for h, w in hw.tolist()]
    rng = np.random.default_rng(916)
    boxes = np.zeros((B, N, 4), np.int32)
    for b in range(B):  # canvas b: every cutout at level b
        for k, (h0, w0) in enumerate(hw.tolist()):
            h, w = round(h0 * scale[b]), round(w0 * scale[b])
            x, y = int(rng.integers(0, W - w + 1)), int(rng.integers(0, H - h + 1))
            boxes[b, k] = (x, y, x + w, y + h)
    geo = ck.render_geometry((H, W), (max(h for h, _ in bounds), max(w for _, w in bounds)),
                             N, bounds, pipelined=True)
    meta = geo.meta(np.broadcast_to(hw, (B, N, 2)).astype(np.int32), boxes, cuda)
    objs_p = ck.planarize_objects(torch.from_numpy(arrays.objects[None])).to(cuda)
    plane = torch.zeros((B, *geo.pad), dtype=torch.int32, device=cuda)
    cols, total = _h_pass_forms(meta.cpu(), tuple(objs_p.shape[3:]), geo.envelope)
    before = ck.fused_v3_h_tally(cuda)
    ck.fused_v3(plane, objs_p, meta, geo.envelope)
    after = ck.fused_v3_h_tally(cuda)
    assert (after[0] - before[0], after[1] - before[1]) == (cols, total)
    assert cols >= 0.95 * total > 0

    arrays = load_bundle("data/squarespace").to_arrays()
    H, W, B = 1920, 1080, 8
    boxes = np.stack([random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(B)])
    hw = np.broadcast_to(arrays.obj_hw, (B, N, 2)).astype(np.int32)
    op = ck.planarize_objects(torch.from_numpy(arrays.objects[None])).to(cuda)
    static = tuple(tuple(int(v) for v in row) for row in arrays.obj_hw)
    ck.reset_launch_counts()
    ck.render_solid_fused_v3_program(op, hw, torch.from_numpy(boxes).to(cuda), (H, W),
                                     ck.pack_rgba_scalar((128, 128, 128, 255)),
                                     pipelined=True, static_obj_hw=static)
    assert ck.fused_v3_h_tally(cuda) == after
    assert ck.LAUNCHES["fused_v3_walks"] == 1 and ck.LAUNCHES["fused_v3_tables"] == 0
