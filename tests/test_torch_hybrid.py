"""The port's two-program hybrid compose (ops/compose_kernels.py:
composite_batch_hybrid_packed, its producers, K4's plain version and the
traced resize) against the JAX package on the CPU.

JAX runs its packed window-blend kernels in interpret mode, with its traced
resample pinned to the exact integer one (``exact_traced_resample``, as the
JAX package's tests/test_compose_pallas.py:20 does). Tolerances:

- against JAX's resize and compose: pixels within 1 (of 255) on at most
  1e-3 of them, since the traced tables sum their weights in another order
  and an entry may differ by 1 unit (tests/test_torch_fused_v3.py);
- against the port's own XLA-path composite (``ops.compose.composite_batch``
  at the rounded envelope), between K4's plain version and the JAX blend
  kernels on the same producer outputs, and for the packing helpers: 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_transformation_tpu.core.bundle import load_bundle as jax_load_bundle
from image_transformation_tpu.ops import compose_pallas as jcp
from image_transformation_tpu.ops import resize as jrz
from image_transformation_tpu.parallel.sweep import random_downscale_boxes
from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.ops import resize as prz
from image_transformation_tpu_torch.ops.compose import composite_batch

BUNDLES = ["squarespace", "audio_book"]
FORMS = [
    {"clamped": False, "pipelined": False},  # row 3
    {"clamped": False, "pipelined": True},  # row 5
    {"clamped": True, "pipelined": False},  # row 6
    {"clamped": True, "pipelined": True},  # row 10
]
FORM_IDS = ["row3", "row5", "row6", "row10"]


@pytest.fixture
def exact_traced_resample(monkeypatch):
    monkeypatch.setattr(jrz, "resample_fixed_traced", jrz.resample_fixed)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _assert_within_one(got, ref, max_share=1e-3):
    d = np.abs(np.asarray(got).astype(np.int64) - np.asarray(ref).astype(np.int64))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= max_share, (d > 0).mean()


def _batch(bundle_name, B, H, W, seed, value=70):
    arrays = jax_load_bundle(f"data/{bundle_name}").to_arrays()
    rng = np.random.default_rng(seed)
    canvases = np.zeros((B, H, W, 4), np.uint8)
    canvases[..., :3] = value
    canvases[..., 3] = 255
    objs = np.broadcast_to(arrays.objects, (B, *arrays.objects.shape)).copy()
    hw = np.broadcast_to(arrays.obj_hw, (B, *arrays.obj_hw.shape)).astype(np.int32)
    boxes = np.stack(
        [random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(B)]
    ).astype(np.int32)
    return canvases, objs, hw, boxes


def _edge_boxes(boxes, obj_hw, H, W):
    """The JAX package's edge stress (tests/test_compose_pallas.py:208-219):
    flush against the corners, hanging off the right and bottom edges, a
    1 px visible corner and a negative-origin drop."""
    oh0, ow0 = (int(v) for v in obj_hw[0, 0])
    boxes[0, 0] = [W - ow0, H - oh0, W, H]
    boxes[1, 0] = [W - ow0 // 2, H - oh0 // 2, W + ow0 // 2, H + oh0 // 2]
    boxes[2, 0] = [-3, 40, -3 + ow0, 40 + oh0]
    oh1, ow1 = (int(v) for v in obj_hw[0, 1])
    boxes[0, 1] = [W - ow1, 0, W, oh1]
    boxes[1, 1] = [0, H - oh1, ow1, H]
    boxes[2, 1] = [W - 1, H - 1, W - 1 + ow1, H - 1 + oh1]
    return boxes


def _run_both(canvases, objs, hw, boxes, **mode):
    """(port output, JAX interpret output, port composite_batch) as numpy."""
    ref_j = np.asarray(jcp.composite_batch_hybrid_packed(
        *(jnp.asarray(x) for x in (canvases, objs, hw, boxes)), interpret=True, **mode))
    ct = torch.from_numpy(canvases)
    out = ck.composite_batch_hybrid_packed(ct, torch.from_numpy(objs), hw, boxes, **mode)
    env = (ck._round_up(objs.shape[2], 8), ck._round_up(objs.shape[3], 128))
    plain = composite_batch(ct, torch.from_numpy(objs), hw, boxes, env)
    return out.numpy(), ref_j, plain.numpy()


# (a) the traced resize and the packing helpers ---------------------------------

def test_resize_f32_matches_jax(exact_traced_resample):
    rng = np.random.default_rng(3)
    lead, hm, wm, out_max = (2, 3), 40, 50, (48, 64)
    img = rng.integers(0, 256, (*lead, hm, wm, 4), dtype=np.uint8)
    in_h = rng.integers(1, hm + 1, lead)
    in_w = rng.integers(1, wm + 1, lead)
    for idx in np.ndindex(*lead):
        img[idx][in_h[idx]:] = 0
        img[idx][:, in_w[idx]:] = 0
    # downscales, upscales past the envelope, identity and 1 px
    out_h = np.array([[5, 70, in_h[0, 2]], [1, 33, 48]])
    out_w = np.array([[9, 80, in_w[0, 2]], [1, 50, 3]])
    ref = jax.vmap(jax.vmap(lambda o, ih, iw, oh, ow: jrz.resize_f32(
        o.astype(jnp.float32), (ih, iw), (oh, ow), out_max)))(
        *(jnp.asarray(x) for x in (img, in_h, in_w, out_h, out_w)))
    got = prz.resize_f32(torch.from_numpy(img), (torch.from_numpy(in_h), torch.from_numpy(in_w)),
                         (torch.from_numpy(out_h), torch.from_numpy(out_w)), out_max)
    assert got.dtype == torch.float32 and tuple(got.shape) == (*lead, *out_max, 4)
    _assert_within_one(got.numpy(), np.asarray(ref))
    assert torch.equal(got[0, 2, :hm, :wm], torch.from_numpy(img[0, 2]).float())  # identity
    for idx in np.ndindex(*lead):
        live = got[idx]
        assert not live[out_h[idx]:].any() and not live[:, out_w[idx]:].any()
    u8 = prz.resize_u8(torch.from_numpy(img), (torch.from_numpy(in_h), torch.from_numpy(in_w)),
                       (torch.from_numpy(out_h), torch.from_numpy(out_w)), out_max)
    assert u8.dtype == torch.uint8 and torch.equal(u8, got.to(torch.uint8))


def test_packed_helpers_match_jax():
    rng = np.random.default_rng(4)
    dst = rng.integers(-2**31, 2**31, (64, 256), dtype=np.int64).astype(np.int32)
    src = rng.integers(-2**31, 2**31, (64, 256), dtype=np.int64).astype(np.int32)
    src[:, ::3] &= 0x00FFFFFF  # alpha 0: the destination passes through
    src[:, 1::7] |= -0x1000000  # alpha 255
    for got, ref in zip(ck._unpack_rgba_u32(torch.from_numpy(dst)),
                        jcp._unpack_rgba_u32(jnp.asarray(dst))):
        assert np.array_equal(got.numpy(), np.asarray(ref))
    channels = torch.from_numpy(dst.view(np.uint8).reshape(64, 256, 4)).to(torch.int32)
    assert np.array_equal(ck._pack_rgba_u32(*channels.unbind(-1)).numpy(), dst)
    got = ck._alpha_over_packed(torch.from_numpy(dst), torch.from_numpy(src))
    ref = jcp._alpha_over_packed(jnp.asarray(dst), jnp.asarray(src))
    assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("clamp", [False, True])
def test_producers_match_jax(clamp, exact_traced_resample):
    canvases, objs, hw, boxes = _batch("squarespace", 3, 300, 400, 19)
    boxes = _edge_boxes(boxes, hw, 300, 400)
    env = (208, 384)
    jprod = jcp._hybrid_producer_clamped if clamp else jcp._hybrid_producer
    pprod = ck._hybrid_producer_clamped if clamp else ck._hybrid_producer
    ref = [np.asarray(x) for x in jprod(*(jnp.asarray(x) for x in (canvases, objs, hw, boxes)),
                                        env, "lanczos")]
    got = pprod(torch.from_numpy(canvases), torch.from_numpy(objs), hw, boxes, env, "lanczos")
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    assert all(g.dtype == torch.int32 and g.is_contiguous() for g in got)
    assert np.array_equal(got[0].numpy(), ref[0])  # the padded plane
    assert np.array_equal(got[2].numpy(), ref[2])  # the window meta
    _assert_within_one(ck.packed_to_u8_np(got[1].numpy()), ck.packed_to_u8_np(ref[1]))


# (b) K4's plain version against the four JAX blend kernels ----------------------

@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
def test_plain_k4_matches_jax_blend_kernels(form, exact_traced_resample):
    """Same producer outputs into the JAX launcher (interpret mode) and the
    port's counterpart: the whole padded plane must agree byte for byte,
    which pins that cutting at the plane's edge is the TPU's window cut."""
    canvases, objs, hw, boxes = _batch("squarespace", 3, 300, 400, 23)
    boxes = _edge_boxes(boxes, hw, 300, 400)
    boxes[0, 2] = boxes[0, 0] + np.array([-40, -30, -40, -30])  # overlaps object 0
    jprod = jcp._hybrid_producer_clamped if form["clamped"] else jcp._hybrid_producer
    canvas_v, src_v, meta = jprod(*(jnp.asarray(x) for x in (canvases, objs, hw, boxes)),
                                  (208, 384), "lanczos")
    name = {(False, False): "_pallas_blend_packed",
            (False, True): "_pallas_blend_packed_pipelined",
            (True, False): "_pallas_blend_packed_clamped",
            (True, True): "_pallas_blend_clamped_pipelined"}[(form["clamped"], form["pipelined"])]
    ref = np.asarray(getattr(jcp, name)(canvas_v, src_v, meta, interpret=True))
    plane = torch.from_numpy(np.array(canvas_v))
    got = getattr(ck, name)(plane, torch.from_numpy(np.array(src_v)),
                            torch.from_numpy(np.array(meta)), interpret=True)
    assert got.data_ptr() == plane.data_ptr()  # blended in place
    assert np.array_equal(got.numpy(), ref)


# (c) composite_batch_hybrid_packed, the four forms --------------------------------

@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
@pytest.mark.parametrize("bundle_name", BUNDLES)
def test_hybrid_matches_jax_and_composite_batch(bundle_name, form, exact_traced_resample):
    canvases, objs, hw, boxes = _batch(bundle_name, 2, 300, 400, 11)
    oh0, ow0 = (int(v) for v in hw[0, 0])
    boxes[0, 0] = [3, 5, 3 + ow0, 5 + oh0]  # identity size
    boxes[1, 0] = [-7, -7, -7 + ow0, -7 + oh0]  # dropped
    out, ref_j, plain = _run_both(canvases, objs, hw, boxes, **form)
    assert out.shape == canvases.shape and out.dtype == np.uint8
    _assert_within_one(out, ref_j)
    assert np.array_equal(out, plain)


@pytest.mark.parametrize("form", FORMS[2:], ids=FORM_IDS[2:])
def test_hybrid_edge_boxes_1080p(form, exact_traced_resample):
    """JAX tests/test_compose_pallas.py:185-230 at 1080x1920 B=3: origins
    capped at the plane edge make dy/dx large in the clamped forms."""
    H, W = 1080, 1920
    canvases, objs, hw, boxes = _batch("squarespace", 3, H, W, 13)
    boxes = _edge_boxes(boxes, hw, H, W)
    out, ref_j, plain = _run_both(canvases, objs, hw, boxes, **form)
    _assert_within_one(out, ref_j)
    assert np.array_equal(out, plain)
    oh0, ow0 = (int(v) for v in hw[0, 0])  # object 0 lies flush in the corner
    assert (out[0, H - oh0:, W - ow0:] != canvases[0, H - oh0:, W - ow0:]).any()


@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
def test_hybrid_tiny_canvas(form, exact_traced_resample):
    """JAX tests/test_compose_pallas.py:233-263: a canvas smaller than one
    window pads up to the window."""
    canvases, objs, hw, boxes = _batch("audio_book", 2, 120, 200, 5, value=0)
    out, ref_j, plain = _run_both(canvases, objs, hw, boxes, **form)
    _assert_within_one(out, ref_j)
    assert np.array_equal(out, plain)


def test_packed_out_is_the_u8_output(exact_traced_resample):
    canvases, objs, hw, boxes = _batch("audio_book", 2, 300, 400, 7)
    ct, ot = torch.from_numpy(canvases), torch.from_numpy(objs)
    packed = ck.composite_batch_hybrid_packed(ct, ot, hw, boxes, clamped=True, packed_out=True)
    u8 = ck.composite_batch_hybrid_packed(ct, ot, hw, boxes, clamped=True)
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (2, 300, 400)
    assert packed.is_contiguous()
    assert np.array_equal(ck.packed_to_u8_np(packed.numpy()), u8.numpy())
    ref = jcp.composite_batch_hybrid_packed(
        *(jnp.asarray(x) for x in (canvases, objs, hw, boxes)), interpret=True,
        clamped=True, packed_out=True)
    _assert_within_one(ck.packed_to_u8_np(packed.numpy()), ck.packed_to_u8_np(np.asarray(ref)))


def test_hybrid_flag_rules():
    canvases, objs, hw, boxes = _batch("audio_book", 1, 64, 96, 2)
    ct, ot = torch.from_numpy(canvases), torch.from_numpy(objs)
    jargs = tuple(jnp.asarray(x) for x in (canvases, objs, hw, boxes))
    for bad in ({}, {"pipelined": True}, {"clamped": True, "pipelined": True},
                {"clamped": True, "band": True}, {"clamped": True, "rowbaked": True}):
        with pytest.raises(ValueError, match="packed_out"):
            ck.composite_batch_hybrid_packed(ct, ot, hw, boxes, packed_out=True, **bad)
        with pytest.raises(ValueError, match="packed_out"):
            jcp.composite_batch_hybrid_packed(*jargs, packed_out=True, interpret=True, **bad)
    # each flag selects its own path whatever ``clamped`` says (JAX :2413-2419)
    env = (ck._round_up(objs.shape[2], 8), ck._round_up(objs.shape[3], 128))
    plain = composite_batch(ct, ot, hw, boxes, env).numpy()
    for flag in ("rowbaked", "band", "batchsrc", "resident"):
        for clamped in (False, True):
            out = ck.composite_batch_hybrid_packed(ct, ot, hw, boxes, clamped=clamped,
                                                   **{flag: True}).numpy()
            ref = jcp.composite_batch_hybrid_packed(*jargs, interpret=True, clamped=clamped,
                                                    **{flag: True})
            _assert_within_one(out, np.asarray(ref))
            assert np.array_equal(out, plain), (flag, clamped)


def test_hybrid_never_writes_the_canvases():
    canvases, objs, hw, boxes = _batch("squarespace", 2, 160, 240, 8)
    ct = torch.from_numpy(canvases)
    for form in FORMS:
        out = ck.composite_batch_hybrid_packed(ct, torch.from_numpy(objs), hw, boxes, **form)
        assert out.data_ptr() != ct.data_ptr()
        assert (out.numpy() != canvases).any()
    ck.composite_batch_hybrid_packed(ct, torch.from_numpy(objs), hw, boxes, clamped=True,
                                     packed_out=True)
    assert np.array_equal(ct.numpy(), canvases)
    assert (canvases[..., :3] == 70).all()


def test_window_blend_checks_its_arguments():
    plane = torch.zeros((2, 16, 128), dtype=torch.int32)
    src = torch.zeros((2, 3, 8, 8), dtype=torch.int32)
    meta = torch.zeros((2, 3, 6), dtype=torch.int32)
    ck.reset_launch_counts()
    assert ck.window_blend(plane, src, meta) is plane
    assert ck.LAUNCHES["window_blend"] == 0  # the CPU runs the plain version
    with pytest.raises(TypeError):
        ck.window_blend(plane, src.to(torch.int64), meta)
    with pytest.raises(ValueError):
        ck.window_blend(plane, src, meta[:, :2].contiguous())
    with pytest.raises(ValueError):
        ck.window_blend(plane, src.transpose(2, 3), meta)
