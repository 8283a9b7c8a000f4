"""The port's gen-3 path (tables on the device, K2's and K3's plain
versions, the render programs) against the JAX package on the CPU.

The same seeded inputs go to JAX (CPU backend) and to the port. Tolerances:

- traced tables: the port sums each row's weights in index order, JAX in
  XLA's order, so a quantized entry may differ by 1 unit; the share of
  such entries is bounded at 1e-4 (measured 147 of 17.7M on this grid);
- composed pixels: at most 1 (of 255) on the [:H, :W] crop against the
  JAX gen-3 kernel in interpret mode and against the XLA composite under
  the ``exact_traced_resample`` pin, the JAX package's own cross-program
  bound (tests/test_parallel.py:192-196); 0 where no table is involved
  (all-identity batches) and between the port's own programs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_transformation_tpu.core.bundle import load_bundle as jax_load_bundle
from image_transformation_tpu.ops import compose_pallas as jcp
from image_transformation_tpu.ops import resize as jrz
from image_transformation_tpu.ops.compose import composite_canvas as jax_composite_canvas
from image_transformation_tpu.ops.compose import composite_exact as jax_composite_exact
from image_transformation_tpu.parallel.sweep import random_downscale_boxes
from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.ops import resize as prz
from image_transformation_tpu_torch.ops.background import gradient_canvas
from image_transformation_tpu_torch.ops.compose import composite_batch

BUNDLES = ["squarespace", "audio_book"]


@pytest.fixture
def exact_traced_resample(monkeypatch):
    """Pin JAX's traced-path resample to its exact integer form (as the
    JAX package's tests/test_compose_pallas.py:20 does)."""
    monkeypatch.setattr(jrz, "resample_fixed_traced", jrz.resample_fixed)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _arrays(name):
    return jax_load_bundle(f"data/{name}").to_arrays()


def _batch(arrays, B, H, W, seed):
    rng = np.random.default_rng(seed)
    hw = np.broadcast_to(arrays.obj_hw, (B, *arrays.obj_hw.shape)).astype(np.int32)
    boxes = np.stack([random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(B)])
    return hw, boxes


def _crop_u8(plane, H, W):
    return ck.packed_to_u8_np(np.asarray(plane))[:, :H, :W]


def _assert_within_one(got, ref, max_share=1e-3):
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= max_share, (d > 0).mean()


# (a) the table functions ----------------------------------------------------

def test_traced_tables_match_jax_tables():
    sizes = [1, 2, 3, 7, 16, 100, 207, 357]
    outs = [1, 2, 5, 50, 103, 207, 300, 357, 600]
    n_in, n_out = 384, 640
    ins_t = torch.tensor([[i] * len(outs) for i in sizes])
    outs_t = torch.tensor([outs] * len(sizes))
    port = prz.build_coeffs_traced(ins_t, outs_t, n_in, n_out).numpy()
    differ = total = 0
    for a, i in enumerate(sizes):
        for b, o in enumerate(outs):
            for ref in (
                jrz.build_coeffs_traced(jnp.int32(i), jnp.int32(o), n_in, n_out),
                jcp._coeff_table_in_kernel(jnp.int32(i), jnp.int32(o), n_out, n_in,
                                           "lanczos", False),
            ):
                d = np.abs(np.asarray(ref).astype(np.int64) - port[a, b])
                assert d.max() <= 1, (i, o, d.max())
                differ += int((d > 0).sum())
                total += d.size
    assert differ / total <= 1e-4, differ


def test_traced_tables_bilinear_and_offset_match_jax():
    for i, o, off in [(100, 37, 0), (20, 55, 3), (1, 1, 0), (357, 5, 7)]:
        ref = np.asarray(jrz.build_coeffs_traced(
            jnp.int32(i), jnp.int32(o), 384, 128, "bilinear", jnp.int32(off)))
        got = prz.build_coeffs_traced(torch.tensor(i), torch.tensor(o), 384, 128,
                                      "bilinear", torch.tensor(off)).numpy()
        assert np.abs(ref.astype(np.int64) - got).max() <= 1


# (b) plain K2 vs the JAX gen-3 kernel (interpret mode) -----------------------

@pytest.mark.parametrize("bundle_name", BUNDLES)
def test_plain_k2_matches_jax_gen3_interpret(bundle_name):
    arrays = _arrays(bundle_name)
    H, W, B = 200, 256, 2
    hw, boxes = _batch(arrays, B, H, W, 11)
    oh0, ow0 = (int(v) for v in arrays.obj_hw[0])
    boxes[1, 0] = [W - ow0 // 2, H - 5, W + ow0 // 2, H - 5 + oh0]  # hangs off
    boxes[0, 1] = [-3, 4, 40, 40]  # dropped
    static = tuple(tuple(int(v) for v in row) for row in arrays.obj_hw)
    bg = jcp.pack_rgba_scalar((40, 50, 60, 255))
    op_j = jcp.planarize_objects(jnp.asarray(arrays.objects)[None])  # shared
    op_p = ck.planarize_objects(torch.from_numpy(arrays.objects)[None])
    assert np.array_equal(np.asarray(op_j), op_p.numpy())
    for static_hw, pipelined in ((None, False), (static, True)):
        ref = jcp.render_solid_fused_v3_program(
            op_j, jnp.asarray(hw), jnp.asarray(boxes), (H, W), bg, interpret=True,
            pipelined=pipelined, static_obj_hw=static_hw,
        )
        got = ck.render_solid_fused_v3_program(
            op_p, hw, boxes, (H, W), bg, pipelined=pipelined, static_obj_hw=static_hw
        )
        assert tuple(got.shape) == tuple(ref.shape)
        _assert_within_one(_crop_u8(got, H, W), _crop_u8(ref, H, W))
        assert (got != bg).any()  # something was composed


@pytest.mark.parametrize("bundle_name", BUNDLES)
def test_all_identity_batch_is_bit_exact(bundle_name):
    """No table on this path: bit-exact vs the exact JAX composite (= PIL)."""
    arrays = _arrays(bundle_name)
    H, W, B = 300, 500, 2
    rng = np.random.default_rng(31)
    canvases = np.zeros((B, H, W, 4), np.uint8)
    canvases[..., :3] = 77
    canvases[..., 3] = 255
    n = arrays.obj_hw.shape[0]
    boxes = np.zeros((B, n, 4), np.int32)
    for b in range(B):
        for k in range(n):
            oh, ow = (int(v) for v in arrays.obj_hw[k])
            x1, y1 = int(rng.integers(0, max(1, W - ow))), int(rng.integers(0, max(1, H - oh)))
            boxes[b, k] = (x1, y1, x1 + ow, y1 + oh)
    hw = np.broadcast_to(arrays.obj_hw, (B, n, 2))
    objs = torch.from_numpy(arrays.objects)[None]
    got = ck.composite_batch_fused_v3(torch.from_numpy(canvases), objs, hw, boxes).numpy()
    for b in range(B):
        ref = np.asarray(jax_composite_exact(canvases[b], arrays.objects, arrays.obj_hw,
                                             boxes[b].tolist()))
        assert np.array_equal(got[b], ref)


def test_input_conventions_agree():
    """u8 vs packed canvases, NHWC vs planar objects, shared vs copied
    objects, padded vs cropped output, solid fill vs an uploaded solid
    canvas, and the single-program renderer: one result, bit for bit."""
    arrays = _arrays("audio_book")
    H, W, B = 150, 300, 2
    hw, boxes = _batch(arrays, B, H, W, 5)
    filled = np.zeros((B, H, W, 4), np.uint8)
    filled[..., :3] = 40
    filled[..., 3] = 255
    objs = torch.from_numpy(np.broadcast_to(arrays.objects, (B, *arrays.objects.shape)).copy())
    ref = ck.composite_batch_fused_v3(torch.from_numpy(filled), objs, hw, boxes)
    packed = torch.from_numpy(filled.view(np.int32).reshape(B, H, W))
    op = ck.planarize_objects(objs)
    got = ck.composite_batch_fused_v3(packed, op, hw, boxes, packed_out=True)
    assert torch.equal(ck.packed_to_u8(got), ref)
    full = ck.composite_batch_fused_v3(
        None, op[:1], hw, boxes, packed_out=True, padded_out=True,
        bg_rgba=(40, 40, 40, 255), canvas_hw=(H, W),
    )
    assert full.shape[0] == B
    assert torch.equal(ck.packed_to_u8(full)[:, :H, :W], ref)
    single = ck.render_solid_fused_v3_program(
        op, hw, boxes, (H, W), ck.pack_rgba_scalar((40, 40, 40, 255)))
    assert torch.equal(single, full)
    with pytest.raises(ValueError):
        ck.composite_batch_fused_v3(None, op, hw, boxes)
    with pytest.raises(ValueError):
        ck.composite_batch_fused_v3(packed, op, hw, boxes, padded_out=True)


# (c) the reuse chain ---------------------------------------------------------

def _reuse_case(seed_boxes, edge=False, B=2, past=False):
    """Objects, sizes and box sets of a small reuse chain. ``edge``: set 3
    is clamped against the bottom/right edges; ``past``: in set 2, object 1
    (9 x 17) of canvas 0 takes a 20 x 60 box, past its size as a bound,
    and the canvas's other objects lie below it."""
    rng = np.random.default_rng(5)
    N, ph, pw = 3, 24, 140
    objs = rng.integers(0, 256, (B, N, ph, pw, 4), dtype=np.uint8)
    hw_row = np.array([[24, 140], [9, 17], [16, 130]], np.int32)
    for k in range(N):
        objs[:, k, hw_row[k, 0]:] = 0
        objs[:, k, :, hw_row[k, 1]:] = 0
    hw = np.broadcast_to(hw_row, (B, N, 2)).copy()
    Hc, Wc = 64, 200

    def rboxes(seed):
        r = np.random.default_rng(seed)
        bx = np.zeros((B, N, 4), np.int32)
        for b in range(B):
            for k in range(N):
                h, w = hw_row[k]
                if edge and seed == 3:  # clamped against the bottom/right edges
                    w2, h2 = min(w, Wc), min(h, Hc)
                    bx[b, k] = (Wc - w2, Hc - h2, Wc, Hc)
                    continue
                s = r.uniform(0.4, 1.0)
                w2, h2 = min(max(1, int(w * s)), Wc), min(max(1, int(h * s)), Hc)
                x1, y1 = r.integers(0, Wc - w2 + 1), r.integers(0, Hc - h2 + 1)
                bx[b, k] = (x1, y1, x1 + w2, y1 + h2)
        if past and seed == 2:  # the others at the bottom, clear of its window
            bx[0] = [(0, 40, 140, 64), (150, 7, 210, 27), (0, 48, 130, 64)]
        return bx

    return objs, hw, hw_row, (Hc, Wc), [rboxes(s) for s in seed_boxes]


@pytest.mark.parametrize("static, B, pipelined", [
    (False, 2, True), (True, 2, True), (True, 1, True), (True, 2, False),
], ids=["False", "True", "True-B1", "True-unpipelined-past"])
def test_reuse_chain_equals_fresh_renders(static, B, pipelined):
    """Each reuse step equals a fresh render: at B = 1 with bounds, and
    with bounds but not pipelined (batch-max windows) where a box runs past
    its bound."""
    objs, hw, hw_row, canvas_hw, sets = _reuse_case([1, 2, 3, 1], edge=static, B=B,
                                                    past=not pipelined)
    static_hw = tuple((int(h), int(w)) for h, w in hw_row) if static else None
    op = ck.planarize_objects(torch.from_numpy(objs))
    bg = ck.pack_rgba_scalar((50, 60, 70, 255))

    def fresh(bx):
        return ck.render_solid_fused_v3_program(
            op, hw, bx, canvas_hw, bg, pipelined=pipelined, static_obj_hw=static_hw)

    plane = fresh(sets[0])
    first = plane.clone()
    for prev, cur in zip(sets, sets[1:]):
        out = ck.render_solid_fused_v3_reuse_program(
            plane, prev, op, hw, cur, canvas_hw, bg, static_obj_hw=static_hw,
            pipelined=pipelined)
        assert out.data_ptr() == plane.data_ptr()  # in place
        assert torch.equal(out, fresh(cur))
    assert torch.equal(plane, first)  # back at the first box set
    with pytest.raises(ValueError):
        ck.render_solid_fused_v3_reuse_program(
            plane[:, :8], sets[0], op, hw, sets[1], canvas_hw, bg)


def test_reuse_step_matches_jax_interpret():
    objs, hw, _, canvas_hw, (b1, b2) = _reuse_case([1, 2])
    bg = jcp.pack_rgba_scalar((50, 60, 70, 255))
    op_j = jcp.planarize_objects(jnp.asarray(objs))
    first = jcp.render_solid_fused_v3_program(
        op_j, jnp.asarray(hw), jnp.asarray(b1), canvas_hw, bg, interpret=True)
    ref = jcp.render_solid_fused_v3_reuse_program(
        first, jnp.asarray(b1), op_j, jnp.asarray(hw), jnp.asarray(b2), canvas_hw, bg,
        interpret=True)
    op = ck.planarize_objects(torch.from_numpy(objs))
    plane = ck.render_solid_fused_v3_program(op, hw, b1, canvas_hw, bg)
    got = ck.render_solid_fused_v3_reuse_program(plane, b1, op, hw, b2, canvas_hw, bg)
    H, W = canvas_hw
    _assert_within_one(_crop_u8(got, H, W), _crop_u8(ref, H, W))


def test_restore_meta_and_windows_match_jax():
    _, hw, hw_row, canvas_hw, (b1,) = _reuse_case([3], edge=True)
    static_hw = tuple((int(h), int(w)) for h, w in hw_row)
    env = (24, 256)
    pad = ck.fused_canvas_pad_hw(canvas_hw, env)
    assert pad == jcp.fused_canvas_pad_hw(canvas_hw, env)
    win = ck._static_window_extents(static_hw, env)
    assert win == jcp._static_window_extents(static_hw, env)
    # the port restores the origins of the render's own meta: JAX's restore rule
    geo = ck.render_geometry(canvas_hw, env, len(static_hw), static_hw, pipelined=True)
    assert (geo.envelope, geo.pad, geo.windows) == (env, pad, win)
    got = geo.meta(hw, torch.from_numpy(b1))[..., :2]
    ref = jcp._restore_meta_static(jnp.asarray(b1), canvas_hw, pad, win)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    MH, MW = ck.window_extents(env)
    for static_win in (None, win):
        got = ck._fused_v3_meta(hw, torch.from_numpy(b1), canvas_hw, pad, (MH, MW), static_win)
        ref = jcp._fused_v3_meta(jnp.asarray(hw), jnp.asarray(b1), canvas_hw, pad, (MH, MW),
                                 static_win=static_win)
        assert np.array_equal(got.numpy(), np.asarray(ref))
    # the restore fills exactly the rectangles, cut at the plane edge
    plane = torch.zeros((2, 10, 12), dtype=torch.int32)
    origins = torch.tensor([[[2, 3], [10, 8]], [[-1, -2], [0, 0]]], dtype=torch.int32)
    ck.restore_windows(plane, origins, ((2, 3), (4, 5)), -7)
    want = torch.zeros_like(plane)
    want[0, 3:5, 2:5] = -7
    want[0, 8:10, 10:12] = -7
    want[1, 0:2, 0:3] = -7
    want[1, 0:4, 0:5] = -7
    assert torch.equal(plane, want)


# (d) fuzz geometries vs the pinned XLA composite ----------------------------

def test_fuzz_geometries_match_pinned_xla_composite(exact_traced_resample):
    arrays = _arrays("audio_book")
    pad = arrays.objects.shape[1:3]
    rng = np.random.default_rng(123)
    n = arrays.objects.shape[0]
    objs = np.broadcast_to(arrays.objects, (2, *arrays.objects.shape)).copy()
    hw = np.broadcast_to(arrays.obj_hw, (2, *arrays.obj_hw.shape)).copy().astype(np.int32)
    for trial in range(4):
        H, W, B = int(rng.integers(40, 400)), int(rng.integers(130, 600)), 2
        canvases = rng.integers(0, 256, (B, H, W, 4), dtype=np.uint8)
        canvases[..., 3] = 255
        boxes = np.zeros((B, n, 4), np.int32)
        for b in range(B):
            for k in range(n):
                oh, ow = int(hw[b, k, 0]), int(hw[b, k, 1])
                mode = rng.integers(0, 5)
                if mode == 0:  # degenerate 1 px box
                    x1, y1 = int(rng.integers(0, W)), int(rng.integers(0, H))
                    boxes[b, k] = (x1, y1, x1 + 1, y1 + 1)
                elif mode == 1:  # identity size, possibly hanging off
                    x1, y1 = int(rng.integers(0, max(1, W - 5))), int(rng.integers(0, max(1, H - 5)))
                    boxes[b, k] = (x1, y1, x1 + ow, y1 + oh)
                elif mode == 2:  # fully off-canvas (dropped)
                    boxes[b, k] = (-ow, -oh, 0, 0)
                else:  # random downscale, may hang off right/bottom
                    s = float(rng.uniform(0.2, 1.0))
                    w, h = max(1, min(int(ow * s), W)), max(1, min(int(oh * s), H))
                    x1, y1 = int(rng.integers(0, W)), int(rng.integers(0, H))
                    boxes[b, k] = (x1, y1, x1 + w, y1 + h)
        got = ck.composite_batch_fused_v3(
            torch.from_numpy(canvases), torch.from_numpy(objs), hw, boxes).numpy()
        # the port's own XLA-path composite: equal bit for bit
        mine = composite_batch(torch.from_numpy(canvases), torch.from_numpy(objs),
                               torch.from_numpy(hw), torch.from_numpy(boxes), pad).numpy()
        assert np.array_equal(got, mine), trial
        dev = tuple(jnp.asarray(x) for x in (canvases, objs, hw, boxes))
        ref = np.asarray(jax.vmap(
            lambda c, o, h_, b: jax_composite_canvas(c, o, h_, b, pad))(*dev))
        _assert_within_one(got, ref)


# (e) the oversized-box clamp --------------------------------------------------

def test_out_of_envelope_box_degrades_gracefully():
    """Mirror of tests/test_compose_pallas.py:424 on the port."""
    H, W, B, n = 256, 384, 1, 2
    pad_h, pad_w = 16, 24
    rng = np.random.default_rng(7)
    objs = np.zeros((B, n, pad_h, pad_w, 4), np.uint8)
    objs[..., :3] = rng.integers(0, 256, (B, n, pad_h, pad_w, 3))
    objs[..., 3] = 255
    hw = np.full((B, n, 2), (pad_h, pad_w), np.int32)
    boxes = np.zeros((B, n, 4), np.int32)
    boxes[0, 0] = [0, 0, 200, 200]  # upscale far beyond the envelope
    boxes[0, 1] = [300, 200, 300 + pad_w, 200 + pad_h]  # identity, disjoint
    canvases = np.zeros((B, H, W, 4), np.uint8)
    canvases[..., 3] = 255
    out = ck.composite_batch_fused_v3(
        torch.from_numpy(canvases), torch.from_numpy(objs), hw, boxes).numpy()
    assert np.array_equal(out[0, 200:200 + pad_h, 300:300 + pad_w], objs[0, 1])
    assert (out[0, :16, :24, :3] != 0).any()
    assert (out[0, 140:200, :200, :3] == 0).all()
    assert (out[0, :, 340:, :3] == 0).all()
    ref = np.asarray(jcp.composite_batch_fused_v3(
        *(jnp.asarray(x) for x in (canvases, objs, hw, boxes)), interpret=True))
    _assert_within_one(out, ref)


# (f) the gradient program ------------------------------------------------------

@pytest.mark.parametrize("horizontal", [True, False])
def test_gradient_program(horizontal):
    arrays = _arrays("audio_book")
    H, W, B = 150, 256, 2
    hw, boxes = _batch(arrays, B, H, W, 77)
    c1 = np.array([[200, 30, 40], [10, 220, 30]], np.uint8)
    c2 = np.array([[20, 40, 230], [240, 240, 10]], np.uint8)
    op = ck.planarize_objects(
        torch.from_numpy(np.broadcast_to(arrays.objects, (B, *arrays.objects.shape)).copy()))
    got = ck.render_gradient_fused_v3_program(
        op, hw, boxes, (H, W), torch.from_numpy(c1), torch.from_numpy(c2), horizontal)
    # equals composing onto the port's own gradient canvas
    canvases = torch.stack([
        gradient_canvas(c1[b], c2[b], H, W, horizontal, torch.device("cpu"))
        for b in range(B)
    ])
    ref = ck.composite_batch_fused_v3(canvases, op, hw, boxes)
    assert torch.equal(ck.packed_to_u8(got)[:, :H, :W], ref)
    if horizontal:  # one orientation against JAX in interpret mode
        jref = jcp.render_gradient_fused_v3_program(
            jnp.asarray(op.numpy()), jnp.asarray(hw), jnp.asarray(boxes), (H, W),
            jnp.asarray(c1), jnp.asarray(c2), horizontal, interpret=True)
        _assert_within_one(_crop_u8(got, H, W), _crop_u8(jref, H, W))


# wrappers -----------------------------------------------------------------------

def test_wrappers_reject_bad_arguments_and_count_no_cpu_launch():
    arrays = _arrays("audio_book")
    hw, boxes = _batch(arrays, 2, 120, 200, 1)
    op = ck.planarize_objects(torch.from_numpy(arrays.objects)[None])
    geo = ck.render_geometry((120, 200), op.shape[3:], op.shape[1])
    meta, env, (hp, wp) = geo.meta(hw, boxes), geo.envelope, geo.pad
    plane = torch.zeros((2, hp, wp), dtype=torch.int32)
    ck.reset_launch_counts()
    ck.fused_v3(plane, op, meta, env)
    ck.restore_windows(plane, meta[..., :2].contiguous(), ((8, 128),) * meta.shape[1], 0)
    assert ck.LAUNCHES == {"fused_compose": 0, "fused_v3": 0, "fused_v3_chunks": 0,
                           "fused_v3_tables": 0, "fused_v3_walks": 0,
                           "fused_v3_own_objects": 0, "restore_windows": 0,
                           "restore_windows_lines": 0, "window_blend": 0,
                           "window_blend_planar": 0, "window_blend_stage": 0, "packed_luma": 0}
    with pytest.raises(TypeError):
        ck.fused_v3(plane.to(torch.int64), op, meta, env)
    with pytest.raises(ValueError):
        ck.fused_v3(plane, op, meta[:, :1].contiguous(), env)
    with pytest.raises(ValueError):
        ck.fused_v3(plane, op.permute(0, 1, 3, 4, 2).contiguous(), meta, env)
    with pytest.raises(ValueError):
        ck.restore_windows(plane, meta[..., :2].contiguous(), ((8, 128),), 0)
    with pytest.raises(ValueError):
        ck.render_solid_fused_v3_program(op, hw, boxes, (120, 200), 0, static_obj_hw=((1, 1),))


def test_packing_helpers_match_jax():
    for rgba in [(0, 0, 0, 0), (255, 255, 255, 255), (128, 128, 128, 255), (1, 2, 3, 200)]:
        assert ck.pack_rgba_scalar(rgba) == jcp.pack_rgba_scalar(rgba)
    rng = np.random.default_rng(0)
    packed = rng.integers(-2**31, 2**31, (3, 20, 30)).astype(np.int32)
    ref = np.asarray(jcp.packed_luma(jnp.asarray(packed)))
    got = ck.packed_luma(torch.from_numpy(packed)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_array_equal(ck.packed_to_u8(torch.from_numpy(packed)).numpy(),
                                  jcp.packed_to_u8_np(packed))
    objs = rng.integers(0, 256, (2, 3, 13, 150, 4), dtype=np.uint8)
    assert np.array_equal(ck.planarize_objects(torch.from_numpy(objs)).numpy(),
                          np.asarray(jcp.planarize_objects(jnp.asarray(objs))))
    for out in [(207, 357), (8, 128), (1, 1)]:
        assert ck.window_extents(out) == jcp.window_extents(out)
        assert ck.fused_canvas_pad_hw((1080, 1920), out) == jcp.fused_canvas_pad_hw(
            (1080, 1920), out)
