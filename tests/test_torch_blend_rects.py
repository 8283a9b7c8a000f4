"""The facts K4's two launches rely on, held on the CPU.

K4 (csrc/window_blend.cu) first finds each placement's rectangle: the
bounding box of its NONZERO source pixels (any plane of a planar source),
at its origin on the plane, of the pixels that land on the plane; then it
blends over those rectangles only. Here, on the plain versions: the torch
reference of the bounds launch (``k4_live_rects_reference``) equals an
independent numpy computation, and blending each placement only inside its
rectangle, in list order, equals the plain blend over the whole envelope
and JAX's packed and planar blend kernels (interpret mode) on the same
inputs. Tolerance 0 throughout (integers).

The random geometries come from ``live_blend_case``
(tests/test_torch_hybrid_cuda.py), which the card tests share.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from image_transformation_tpu.ops import compose_pallas as jcp
from image_transformation_tpu_torch.ops import compose_kernels as ck
from tests.test_torch_hybrid_cuda import _planar, _sources, live_blend_case


def _rects_numpy(live, meta, plane_hw):
    """Each placement's rectangle, one by one with numpy: ``live`` bool
    [B, N, mh, mw] (nonzero source pixels)."""
    B, N, mh, mw = live.shape
    out = np.zeros((B, N, 4), np.int64)
    for b in range(B):
        for k in range(N):
            ws_x, ws_y, dx, dy, _, valid = (int(v) for v in meta[b, k])
            if valid <= 0:
                continue
            x, y = ws_x + dx, ws_y + dy
            on = live[b, k].copy()
            if plane_hw is not None:
                hp, wp = plane_hw
                on[:max(0, -y)] = False
                on[max(0, hp - y):] = False
                on[:, :max(0, -x)] = False
                on[:, max(0, wp - x):] = False
            rows, cols = np.nonzero(on.any(1))[0], np.nonzero(on.any(0))[0]
            if rows.size:
                out[b, k] = (x + cols[0], y + rows[0], cols[-1] + 1 - cols[0],
                             rows[-1] + 1 - rows[0])
    return out


@pytest.mark.parametrize("clip", [False, True], ids=["envelope", "on_plane"])
@pytest.mark.parametrize("layout", ["packed", "planar"])
@pytest.mark.parametrize("seed", range(4))
def test_live_rects_reference_matches_numpy(seed, layout, clip):
    plane, src, meta = live_blend_case(seed)
    plane_hw = tuple(plane.shape[1:]) if clip else None
    live = src.numpy() != 0
    if layout == "planar":
        src = _planar(src)
    got = ck.k4_live_rects_reference(src, meta, plane_hw)
    assert got.dtype == torch.int32 and got.shape == (*src.shape[:2], 4)
    assert np.array_equal(got.numpy(), _rects_numpy(live, meta.numpy(), plane_hw))


def _blend_rects(plane, src, meta, rects):
    """The plain blend cut to ``rects``: each placement, in list order,
    alpha-over only inside its rectangle. Updates ``plane`` in place."""
    for b in range(plane.shape[0]):
        for k in range(src.shape[1]):
            x, y, w, h = (int(v) for v in rects[b, k])
            if w == 0:
                continue
            ox = int(meta[b, k, 0] + meta[b, k, 2])
            oy = int(meta[b, k, 1] + meta[b, k, 3])
            win = plane[b, y:y + h, x:x + w]
            win.copy_(ck._alpha_over_packed(win, src[b, k, y - oy:y - oy + h, x - ox:x - ox + w]))
    return plane


@pytest.mark.parametrize("seed", range(6))
def test_blend_over_live_rects_equals_the_whole_envelope(seed):
    """The design's premise on K4's own random geometries: outside its
    rectangle a source holds only zeros, which Pillow's alpha-over leaves
    as they are, and the rectangles (cut at the plane) lie on the plane."""
    plane, src, meta = live_blend_case(100 + seed)
    rects = ck.k4_live_rects_reference(src, meta, tuple(plane.shape[1:]))
    hp, wp = plane.shape[1:]
    r = rects.to(torch.int64)
    on = (r[..., 2] == 0) | ((r[..., 0] >= 0) & (r[..., 1] >= 0) & (r[..., 0] + r[..., 2] <= wp)
                             & (r[..., 1] + r[..., 3] <= hp))
    assert bool(on.all())
    want = ck.window_blend_reference(plane.clone(), src, meta)
    assert torch.equal(_blend_rects(plane.clone(), src, meta, rects), want)
    # the planar entry's plain version agrees on the same pixels
    got_p = ck.window_blend_planar_reference(_planar(plane), _planar(src), meta)
    assert torch.equal(got_p, _planar(want))


def _jax_case(seed):
    """The unclamped hybrid geometry at a small size (as JAX's launchers
    take it: the plane padded by a full window, origins on (8, 128)
    multiples): B=2 canvases, N=4, a 64x128 envelope, boxes anywhere on the
    canvas incl. dropped ones, sources zero outside a live box."""
    rng = np.random.default_rng(seed)
    B, N, (mh, mw) = 2, 4, (64, 128)
    H, W = int(rng.integers(40, 120)), int(rng.integers(60, 260))
    hp, wp = ck._legacy_canvas_pad_hw((H, W), ck.window_extents((mh, mw)))
    plane = rng.integers(-2**31, 2**31, (B, hp, wp), dtype=np.int64).astype(np.int32)
    src = _sources(rng, B, N, mh, mw)
    xy = np.stack([rng.integers(-8, W + 4, (B, N)), rng.integers(-8, H + 4, (B, N))], -1)
    boxes = np.concatenate([xy, xy + 1], -1)  # only the origin is read
    meta = ck._window_meta6(torch.from_numpy(boxes), (H, W)).contiguous()
    return torch.from_numpy(plane), torch.from_numpy(src), meta


@pytest.mark.parametrize("seed", range(3))
def test_blend_over_live_rects_equals_jax_kernels(seed):
    plane, src, meta = _jax_case(seed)
    rects = ck.k4_live_rects_reference(src, meta, tuple(plane.shape[1:]))
    got = _blend_rects(plane.clone(), src, meta, rects)
    assert torch.equal(got, ck.window_blend_reference(plane.clone(), src, meta))
    j = (jnp.asarray(plane.numpy()), jnp.asarray(src.numpy()), jnp.asarray(meta.numpy()))
    assert np.array_equal(got.numpy(), np.asarray(jcp._pallas_blend_packed(*j, interpret=True)))
    jp = (jnp.asarray(_planar(plane).numpy()), jnp.asarray(_planar(src).numpy()), j[2])
    ref_p = np.asarray(jcp._pallas_blend_planar(*jp, interpret=True))
    assert np.array_equal(_planar(got).numpy(), ref_p)
