"""The rest of the JAX ``ops`` compose API in the port, held against the JAX
package on the CPU: ``resize_f32_shifted``, the row-baked, window-aligned
and planar producers, and the plain versions of K4's entries and K1 against
each JAX launcher they replace (rows 1, 2, 4, 7, 8, 9 and 11 of the kernel
table, in interpret mode), K4's stage variants (row 15) against their stated
semantics, and the ``ops`` export list.

JAX's traced resample is pinned to the exact integer one
(``exact_traced_resample`` of tests/test_torch_hybrid.py). Tolerances:

- resampled pixels against JAX: within 1 (of 255) on at most 1e-3 of them,
  since the f32 tables sum their weights in another order and an entry may
  differ by 1 unit;
- planes, metas, tables under a shift, and every plain version against its
  JAX launcher on the same inputs: 0 (byte for byte on the whole plane).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_transformation_tpu.ops import compose_pallas as jcp
from image_transformation_tpu.ops import resize as jrz
from image_transformation_tpu_torch import ops as port_ops
from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.ops import resize as prz
from image_transformation_tpu_torch.ops.resize import build_coeffs_host
from tests.test_torch_hybrid import (  # noqa: F401  (the fixture is used by name)
    _assert_within_one,
    _batch,
    _edge_boxes,
    exact_traced_resample,
)

ENV = (208, 384)  # squarespace's pad 207x357 rounded to (8, 128)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _edge_batch(seed, H=300, W=400):
    canvases, objs, hw, boxes = _batch("squarespace", 3, H, W, seed)
    boxes = _edge_boxes(boxes, hw, H, W)
    boxes[0, 2] = boxes[0, 0] + np.array([-40, -30, -40, -30])  # overlaps object 0
    oh3, ow3 = (int(v) for v in hw[0, 3])
    boxes[1, 3] = [3, 5, 3 + ow3, 5 + oh3]  # identity size
    return canvases, objs, hw, boxes


# (a) resize_f32_shifted -----------------------------------------------------------

@pytest.mark.parametrize("off", [(0, 0), (3, 70), (7, 127), (40, 200)])
def test_shifted_tables_are_the_unshifted_rows(off):
    """Row o of a table built with offset ``off`` is row o - off of the
    unshifted table, bit for bit; rows before the offset are zero."""
    rng = np.random.default_rng(sum(off))
    in_size = torch.from_numpy(rng.integers(1, 300, (2, 5)))
    out_size = torch.from_numpy(rng.integers(1, 300, (2, 5)))
    for o in off:
        base = prz.build_coeffs_traced(in_size, out_size, 300, 256)
        shifted = prz.build_coeffs_traced(in_size, out_size, 300, 256 + o,
                                          out_offset=torch.full((2, 5), o))
        assert torch.equal(shifted[..., o:, :], base)
        assert not shifted[..., :o, :].any()


def test_resize_f32_shifted_matches_jax(exact_traced_resample):
    rng = np.random.default_rng(5)
    lead, hm, wm, out_max = (2, 3), 40, 50, (64, 192)
    img = rng.integers(0, 256, (*lead, hm, wm, 4), dtype=np.uint8)
    in_h = rng.integers(1, hm + 1, lead)
    in_w = rng.integers(1, wm + 1, lead)
    for idx in np.ndindex(*lead):
        img[idx][in_h[idx]:] = 0
        img[idx][:, in_w[idx]:] = 0
    out_h = np.array([[5, 70, 33], [1, 20, 48]])
    out_w = np.array([[9, 80, 50], [1, 60, 3]])
    dy = np.array([[0, 3, 7], [15, 60, 0]])
    dx = np.array([[0, 127, 5], [100, 0, 189]])
    ref = jax.vmap(jax.vmap(lambda o, ih, iw, oh, ow, y, x: jrz.resize_f32_shifted(
        o.astype(jnp.float32), (ih, iw), (oh, ow), (y, x), out_max)))(
        *_j(img, in_h, in_w, out_h, out_w, dy, dx))
    got = prz.resize_f32_shifted(torch.from_numpy(img), _t(in_h, in_w), _t(out_h, out_w),
                                 _t(dy, dx), out_max)
    assert got.dtype == torch.float32 and tuple(got.shape) == (*lead, *out_max, 4)
    _assert_within_one(got.numpy(), np.asarray(ref))
    # the live region starts at the offset and equals the unshifted resize
    plain = prz.resize_f32(torch.from_numpy(img), _t(in_h, in_w), _t(out_h, out_w), out_max)
    for idx in np.ndindex(*lead):
        y, x = int(dy[idx]), int(dx[idx])
        live = got[idx]
        assert not live[:y].any() and not live[:, :x].any()
        if (out_h[idx], out_w[idx]) != (in_h[idx], in_w[idx]):  # resize_f32 copies those
            assert torch.equal(live[y:, x:], plain[idx][:out_max[0] - y, :out_max[1] - x])


# (b) the producers ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["_hybrid_producer_rowbaked", "_hybrid_producer_aligned"])
def test_shifted_producers_match_jax(name, exact_traced_resample):
    canvases, objs, hw, boxes = _edge_batch(19)
    ref = [np.asarray(x) for x in getattr(jcp, name)(*_j(canvases, objs, hw, boxes),
                                                     ENV, "lanczos")]
    got = getattr(ck, name)(torch.from_numpy(canvases), torch.from_numpy(objs), hw, boxes,
                            ENV, "lanczos")
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    assert all(g.dtype == torch.int32 and g.is_contiguous() for g in got)
    assert np.array_equal(got[0].numpy(), ref[0])  # the padded plane
    assert np.array_equal(got[2].numpy(), ref[2])  # the window meta
    _assert_within_one(ck.packed_to_u8_np(got[1].numpy()), ck.packed_to_u8_np(ref[1]))
    # the identity-size object is the raw copy, shifted: exact
    assert np.array_equal(got[1][1, 3].numpy(), ref[1][1, 3])
    if name == "_hybrid_producer_rowbaked":  # a source spans its whole window
        src_hw = tuple(got[1].shape[2:])
        assert ck.window_extents_rowbaked(src_hw) == jcp.window_extents_rowbaked(src_hw) == \
            ck.window_extents(ENV)


# (c) the plain versions against the JAX launchers (interpret mode) ----------------

@pytest.mark.parametrize("launcher,producer", [
    ("_pallas_blend_clamped_batchsrc", "_hybrid_producer_clamped"),  # row 7
    ("_pallas_blend_resident", "_hybrid_producer_clamped"),  # row 8
    ("_pallas_blend_band", "_hybrid_producer_clamped"),  # row 9
    ("_pallas_blend_rowbaked", "_hybrid_producer_rowbaked"),  # row 11
    ("_pallas_blend_aligned", "_hybrid_producer_aligned"),  # row 4
], ids=["row7", "row8", "row9", "row11", "row4"])
def test_plain_k4_matches_jax_launcher(launcher, producer, exact_traced_resample):
    """The JAX producer's outputs into the JAX launcher and into the port's:
    the whole padded plane agrees byte for byte."""
    canvases, objs, hw, boxes = _edge_batch(23)
    canvas_v, src_v, meta = getattr(jcp, producer)(*_j(canvases, objs, hw, boxes),
                                                   ENV, "lanczos")
    ref = np.asarray(getattr(jcp, launcher)(canvas_v, src_v, meta, interpret=True))
    plane, src, m = _t(canvas_v, src_v, meta)
    got = getattr(ck, launcher)(plane, src, m, interpret=True)
    assert got.data_ptr() == plane.data_ptr()  # blended in place
    assert np.array_equal(got.numpy(), ref)
    assert (got.numpy() != np.asarray(canvas_v)).any()


def test_plain_planar_k4_matches_jax_planar_blend(exact_traced_resample):
    """Row 2: the port's planar producer outputs into JAX's
    ``_pallas_blend_planar`` and the port's, byte for byte."""
    canvases, objs, hw, boxes = _edge_batch(29)
    canvas_p, src_p, meta = ck._hybrid_producer_planar(
        torch.from_numpy(canvases), torch.from_numpy(objs), hw, boxes, ENV, "lanczos")
    assert canvas_p.dtype == src_p.dtype == torch.uint8
    assert tuple(src_p.shape) == (3, 4, 4, *ENV)
    ref = np.asarray(jcp._pallas_blend_planar(*_j(canvas_p, src_p, meta), interpret=True))
    before = canvas_p.clone()
    got = ck._pallas_blend_planar(canvas_p, src_p, meta)
    assert got.data_ptr() == canvas_p.data_ptr()
    assert np.array_equal(got.numpy(), ref)
    assert not torch.equal(got, before)


def test_plain_gen1_matches_jax_compose_planar():
    """Row 1: JAX's padded planar arguments (composite_batch_pallas :997-1024,
    host tables) into ``_pallas_compose_planar``, JAX's and the port's (on
    K1's plain version): the whole padded planar canvas byte for byte."""
    canvases, objs, hw, boxes = _edge_batch(31)
    B, N = boxes.shape[:2]
    H, W = canvases.shape[1:3]
    ph, pw = objs.shape[2:4]
    kh = np.zeros((B, N, pw, pw), np.int32)
    kv = np.zeros((B, N, ph, ph), np.int32)
    for b, k in np.ndindex(B, N):
        x1, y1, x2, y2 = (int(v) for v in boxes[b, k])
        kh[b, k] = build_coeffs_host(int(hw[b, k, 1]), max(1, x2 - x1), pw, pw)
        kv[b, k] = build_coeffs_host(int(hw[b, k, 0]), max(1, y2 - y1), ph, ph)
    ph_a, pw_a, mh_a, mw_a = ck._round_up(ph, 8), ck._round_up(pw, 128), ck._round_up(ph, 128), \
        ck._round_up(pw, 8)
    objs_p = np.pad(objs, ((0, 0), (0, 0), (0, ph_a - ph), (0, pw_a - pw), (0, 0)))
    objs_p = objs_p.transpose(0, 1, 4, 2, 3).copy()
    kh = np.pad(kh, ((0, 0), (0, 0), (0, mw_a - pw), (0, pw_a - pw)))
    kv_t = np.pad(kv, ((0, 0), (0, 0), (0, mh_a - ph), (0, ph_a - ph))).transpose(0, 1, 3, 2)
    kv_t = kv_t.copy()
    w = np.maximum(1, boxes[..., 2] - boxes[..., 0])
    h = np.maximum(1, boxes[..., 3] - boxes[..., 1])
    same = (w == hw[..., 1]) & (h == hw[..., 0])
    meta = np.asarray(jcp._window_meta6(jnp.asarray(boxes), (H, W), same=jnp.asarray(same)))
    hp, wp = ck._legacy_canvas_pad_hw((H, W), ck.window_extents((mh_a, mw_a)))
    canvas_p = np.pad(canvases.transpose(0, 3, 1, 2), ((0, 0), (0, 0), (0, hp - H), (0, wp - W)))
    ref = np.asarray(jcp._pallas_compose_planar(*_j(canvas_p, objs_p, kh, kv_t, meta),
                                                interpret=True))
    plane = torch.from_numpy(canvas_p.copy())
    got = ck._pallas_compose_planar(plane, *_t(objs_p, kh, kv_t, meta))
    assert got.data_ptr() == plane.data_ptr()
    assert np.array_equal(got.numpy(), ref)
    assert (ref != canvas_p).any()


# (d) the stage variants (row 15) ---------------------------------------------------

def _stage_case(seed):
    rng = np.random.default_rng(seed)
    B, N, mh, mw = 2, 5, 24, 128
    MH, MW = ck.window_extents((mh, mw))
    H, W = 100, 300
    hp, wp = ck._clamped_pad_hw((H, W), (MH, MW))
    plane = rng.integers(-2**31, 2**31, (B, hp, wp), dtype=np.int64).astype(np.int32)
    src = rng.integers(-2**31, 2**31, (B, N, mh, mw), dtype=np.int64).astype(np.int32)
    src[rng.random(src.shape) < 0.3] &= 0x00FFFFFF  # alpha 0
    x1 = rng.integers(-5, W + 3, (B, N))
    y1 = rng.integers(-5, H + 3, (B, N))
    x1[0, :2], y1[0, :2] = W - 9, H - 3  # capped origins: large dx, dy
    boxes = np.stack([x1, y1, x1 + mw, y1 + mh], -1)
    meta = ck._window_meta6(torch.from_numpy(boxes), (H, W), origin_cap=(hp - MH, wp - MW))
    return torch.from_numpy(plane), torch.from_numpy(src), meta.contiguous()


def _place(plane, src, meta, use_dx, use_dy):
    """The stated placement of a blending stage variant, written out: each
    valid source alpha-overed at (ws_x + dx?, ws_y + dy?), cut at the plane."""
    out = plane.clone()
    hp, wp = plane.shape[1:]
    mh, mw = src.shape[2:]
    for b, rows in enumerate(meta.tolist()):
        for k, (ws_x, ws_y, dx, dy, _, valid) in enumerate(rows):
            if not valid:
                continue
            x, y = ws_x + (dx if use_dx else 0), ws_y + (dy if use_dy else 0)
            for r in range(max(y, 0), min(y + mh, hp)):
                seg = out[b, r, max(x, 0):min(x + mw, wp)]
                s = src[b, k, r - y, max(x, 0) - x:min(x + mw, wp) - x]
                seg.copy_(ck._alpha_over_packed(seg, s))
    return out


@pytest.mark.parametrize("variant", ck.STAGE_VARIANTS)
def test_stage_variants_plain_versions(variant):
    plane, src, meta = _stage_case(3)
    want = {"full": _place(plane, src, meta, True, True),
            "no_roll": _place(plane, src, meta, False, True),
            "no_shift": _place(plane, src, meta, True, False)}.get(variant, plane.clone())
    work = plane.clone()
    ck.reset_launch_counts()
    got = ck.window_blend_stage(work, src, meta, variant)
    assert got.data_ptr() == work.data_ptr()
    assert torch.equal(got, want)
    assert ck.LAUNCHES["window_blend_stage"] == 0  # the CPU runs the plain version
    assert variant in ("no_blend", "dma_only") or not torch.equal(got, plane)


def test_no_shift_stage_is_jax_rowbaked_blend():
    """``no_shift`` places at row ws_y and rolls by dx with the lane mask:
    what JAX's row-baked launcher does (interpret mode), byte for byte."""
    plane, src, meta = _stage_case(4)
    ref = np.asarray(jcp._pallas_blend_rowbaked(*_j(plane, src, meta), interpret=True))
    got = ck.window_blend_stage(plane.clone(), src, meta, "no_shift")
    assert np.array_equal(got.numpy(), ref)


def test_stage_variant_names_are_checked():
    plane, src, meta = _stage_case(5)
    with pytest.raises(ValueError, match="variant"):
        ck.window_blend_stage(plane, src, meta, "no_dma")


# (e) the export list ---------------------------------------------------------------

def test_ops_exports_the_jax_ops_names():
    init = Path(jcp.__file__).with_name("__init__.py")
    names = {alias.asname or alias.name
             for node in ast.walk(ast.parse(init.read_text()))
             if isinstance(node, ast.ImportFrom) for alias in node.names}
    assert set(port_ops.__all__) == names and len(port_ops.__all__) == len(names)
    for name in names:
        assert callable(getattr(port_ops, name)), name
