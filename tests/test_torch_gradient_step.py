"""The gradient render step (``parallel.sweep.make_gradient_render_step``) on
the CPU, where it runs the plain versions of K2 and of K3's ramp form.

A chain of reuse steps equals fresh renders byte for byte, and matches the
benchmark's plain reference (``bench_torch.reference``: Pillow's resize and
alpha_composite on the upstream fill_gradient canvas) exactly off every box.
On the boxes it is within 1 where boxes downscale. Where they upscale past
the assets, K2's envelope exceeds the objects' pad and its growing axes take
the exact-argument tables (``ops.resize.build_coeffs_v3``), whose float32
lanczos and weight sums leave a coefficient up to 2 units of 2^22 from
Pillow's. A unit flips an intermediate's rounding; the vertical pass's
positive lobes (summing past 1) and the unpremultiply of a partial alpha
can carry two such flips into one output value, so a few values in a thousand
read 2, on soft-alpha objects and on the resampled (soft) edges of
binary-alpha ones alike. With Pillow's own tables put in K2's place the
chain equals the reference exactly in both regimes: the tables are the whole
of the difference (the benchmark's ``pixel_max_err`` limit of 2 has the same
origin). Both gradient axes, boxes that downscale and boxes that upscale up
to 4x, seeded random RGBA objects (half with soft alpha) at a small size.
"""

import numpy as np
import pytest
import torch

from bench_torch import reference
from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.ops.background import gradient_spec
from image_transformation_tpu_torch.parallel import make_gradient_render_step, make_solid_render_step

H, W = 96, 160
OBJ_HW = np.array([[12, 20], [9, 14], [12, 8], [5, 17]])
B, STEPS = 3, 4
SCALES = {"down": (0.3, 1.0), "up": (1.0, 4.0)}


def _objects(seed):
    """u8 [1, N, 12, 20, 4], zero past each object's size; objects 0 and 2
    have soft alpha, 1 and 3 binary alpha."""
    rng = np.random.default_rng(seed)
    objs = np.zeros((1, len(OBJ_HW), 12, 20, 4), np.uint8)
    for k, (h, w) in enumerate(OBJ_HW):
        px = rng.integers(0, 256, (h, w, 4))
        if k % 2:
            px[..., 3] = np.where(px[..., 3] > 96, 255, 0)
        objs[0, k, :h, :w] = px
    return objs


def _background(horizontal):
    """An RGBA background image whose edge strips make the gradient run
    along ``horizontal``'s axis: upstream's rule takes the axis whose end
    strips differ least, so the image varies a little along that axis and
    much across it."""
    y, x = np.mgrid[0:40, 0:60]
    along, across = (x / 59, y / 39) if horizontal else (y / 39, x / 59)
    rgb = (np.array([180, 40, 70]) + along[..., None] * np.array([-60, 90, 40])
           + across[..., None] * np.array([70, 120, -60]) * (2 * (across[..., None] > 0.5) - 1))
    bg = np.full((40, 60, 4), 255, np.uint8)
    bg[..., :3] = np.clip(rgb, 0, 255).astype(np.uint8)
    return bg


def _box_sets(seed, regime, steps=STEPS, batch=B):
    """int32 [steps, batch, N, 4]: each object at a scale drawn from the
    regime's range, the whole box inside the canvas."""
    rng = np.random.default_rng(seed)
    lo, hi = SCALES[regime]
    out = np.zeros((steps, batch, len(OBJ_HW), 4), np.int32)
    for i in range(steps):
        for b in range(batch):
            for k, (h, w) in enumerate(OBJ_HW):
                s = rng.uniform(lo, hi)
                bw, bh = max(1, round(w * s)), max(1, round(h * s))
                x, y = rng.integers(0, W - bw + 1), rng.integers(0, H - bh + 1)
                out[i, b, k] = (x, y, x + bw, y + bh)
    return out


def _bounds(regime):
    hi = SCALES[regime][1]
    return tuple((round(h * hi), round(w * hi)) for h, w in OBJ_HW.tolist())


def _steps(horizontal, regime, stat, reuse=True):
    spec = gradient_spec(torch.from_numpy(_background(horizontal)))
    assert spec[2] == horizontal
    return make_gradient_render_step((H, W), _bounds(regime), spec, reuse=reuse, stat=stat,
                                     device="cpu")


def _hw(batch=B):
    return np.broadcast_to(OBJ_HW, (batch, *OBJ_HW.shape)).astype(np.int32)


def _crop(plane, b):
    return ck.packed_to_u8(plane[b, :H, :W])


def _objects_by_id(objs):
    return {k: np.ascontiguousarray(objs[0, k, :h, :w]) for k, (h, w) in enumerate(OBJ_HW)}


CHAIN_CASES = [
    pytest.param(horizontal, regime, stat, B, id=f"{axis}-{regime}-{stat}")
    for stat in ("luma", "fence") for regime in ("down", "up")
    for horizontal, axis in ((True, "horizontal"), (False, "vertical"))
] + [pytest.param(True, "down", "luma", 1, id="horizontal-down-luma-B1")]


@pytest.mark.parametrize("horizontal, regime, stat, batch", CHAIN_CASES)
def test_gradient_reuse_chain_equals_fresh_renders(horizontal, regime, stat, batch):
    objs, sets, hw = _objects(1), _box_sets(2, regime, batch=batch), _hw(batch)
    step = _steps(horizontal, regime, stat)
    fresh = _steps(horizontal, regime, stat, reuse=False)
    objs_p = ck.planarize_objects(torch.from_numpy(objs))
    first, _ = step(None, objs_p, hw, sets[0])
    for bx in sets[1:]:
        plane, st = step(None, objs_p, hw, bx)
        assert plane.data_ptr() == first.data_ptr()  # restored and composed in place
        want, want_st = fresh(None, objs, hw, bx)
        assert torch.equal(plane, want) and torch.equal(st, want_st)
    step.release()
    plane, _ = step(None, objs_p, hw, sets[0])
    assert plane.data_ptr() != first.data_ptr()


def test_the_step_decides_its_geometry_once_and_restores_the_meta_it_drew(monkeypatch):
    """One geometry per step factory, over reuse calls and a release; each
    reuse call's restore origins are columns 0-1 of the meta its previous
    call gave K2, and its extents the per-object windows of the bounds."""
    from image_transformation_tpu_torch.parallel import sweep

    built, drawn, restored = [], [], []
    build, fused, restore = sweep.render_geometry, ck.fused_v3, ck.restore_windows

    def counted_build(*args, **kwargs):
        built.append(build(*args, **kwargs))
        return built[-1]

    def kept_fused(plane, objs_p, meta, env):
        drawn.append(meta)
        return fused(plane, objs_p, meta, env)

    def kept_restore(plane, origins, extents, bg):
        restored.append((origins, extents))
        return restore(plane, origins, extents, bg)

    monkeypatch.setattr(sweep, "render_geometry", counted_build)
    monkeypatch.setattr(ck, "fused_v3", kept_fused)
    monkeypatch.setattr(ck, "restore_windows", kept_restore)
    objs, sets = _objects(1), _box_sets(2, "down")
    step = _steps(True, "down", "fence")
    for bx in [*sets, None, sets[0], sets[1]]:
        if bx is None:
            step.release()
            continue
        step(None, objs, _hw(), bx)
    assert len(built) == 1 and len(drawn) == len(sets) + 2
    windows = ck._static_window_extents(_bounds("down"), built[0].envelope)
    assert built[0].windows == windows and built[0].per_object
    pairs = [(drawn[i - 1], restored.pop(0)) for i in (1, 2, 3, 5)]  # call 4 is fresh
    assert not restored
    for prev_meta, (origins, extents) in pairs:
        assert torch.equal(origins, prev_meta[..., :2]) and extents == windows


def _chain_errors(horizontal, regime):
    """Yield (boxes, crop, reference, luma) of each canvas of a reuse chain."""
    objs, sets = _objects(3), _box_sets(4, regime)
    bg = _background(horizontal)
    base = reference.background_canvas(bg, (W, H), "gradient")
    objects = _objects_by_id(objs)
    step = _steps(horizontal, regime, "luma")
    for bx in sets:
        plane, luma = step(None, objs, _hw(), bx)
        for b in range(B):
            got = _crop(plane, b).to(torch.int16)
            ref = reference.compose(base, objects, list(enumerate(bx[b].tolist())), "cpu")
            yield bx[b], got, ref, base, float(luma[b])


@pytest.mark.parametrize("regime", ["down", "up"])
@pytest.mark.parametrize("horizontal", [True, False], ids=["horizontal", "vertical"])
def test_gradient_reuse_chain_matches_the_reference(horizontal, regime):
    for bx, got, ref, base, luma in _chain_errors(horizontal, regime):
        d = (got - ref.to(torch.int16)).abs()
        if regime == "down":
            assert int(d.max()) <= 1
        else:  # K2's exact-argument tables: see the module docstring
            assert int(d.max()) <= 2 and float((d > 1).float().mean()) <= 1e-3
        off = np.ones((H, W), bool)
        for x1, y1, x2, y2 in bx.tolist():
            off[y1:y2, x1:x2] = False
        assert torch.equal(got[torch.from_numpy(off)], torch.from_numpy(base[off]).to(torch.int16))
        assert abs(luma - reference.luma(ref)) <= 1.0 / 255 * 3


def _pillow_tables(in_size, out_size, in_max, out_max):
    """K2's table builders' signature with Pillow's own tables
    (``bench_torch.reference.coefficients``), zero-padded."""
    out = torch.zeros((*in_size.shape, out_max, in_max), dtype=torch.int32)
    flat = out.view(-1, out_max, in_max)
    for j, (n_in, n_out) in enumerate(zip(in_size.reshape(-1).tolist(),
                                          out_size.reshape(-1).tolist())):
        if n_in > 0 and n_out > 0:
            flat[j, :n_out, :n_in] = torch.from_numpy(reference.coefficients(n_in, n_out))
    return out


@pytest.mark.parametrize("regime", ["down", "up"])
@pytest.mark.parametrize("horizontal", [True, False], ids=["horizontal", "vertical"])
def test_with_pillow_tables_the_chain_equals_the_reference(horizontal, regime, monkeypatch):
    """The chain's only departure from the reference is K2's tables: with
    Pillow's in their place every value is equal."""
    monkeypatch.setattr(ck, "build_coeffs_v3", _pillow_tables)
    monkeypatch.setattr(ck, "build_coeffs_traced", _pillow_tables)
    for _, got, ref, _, _ in _chain_errors(horizontal, regime):
        assert torch.equal(got, ref.to(torch.int16))


@pytest.mark.parametrize("horizontal", [True, False], ids=["horizontal", "vertical"])
def test_k3_ramp_plain_version_equals_a_direct_window_fill(horizontal):
    rng = np.random.default_rng(5)
    Bp, N, hp, wp = 2, 5, 40, 256
    plane = torch.from_numpy(rng.integers(-2**31, 2**31, (Bp, hp, wp)).astype(np.int32))
    n = wp if horizontal else hp
    ramp = ck.GradientRamp(torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32)),
                           horizontal)
    extents = tuple((int(h), int(w)) for h, w in rng.integers(1, 60, (N, 2)) * [1, 5])
    origins = rng.integers(-30, 270, (Bp, N, 2)).astype(np.int32)
    origins[0, 0] = (wp - 3, hp - 2)  # cut at the bottom right corner
    origins[1, 0] = (-4, -7)  # cut at the top left corner
    want = plane.numpy().copy()
    line = ramp.values.numpy()
    for b in range(Bp):
        for k in range(N):
            x, y = origins[b, k]
            h, w = extents[k]
            for yy in range(max(y, 0), min(y + h, hp)):
                for xx in range(max(x, 0), min(x + w, wp)):
                    want[b, yy, xx] = line[xx] if horizontal else line[yy]
    got = ck.restore_windows(plane, torch.from_numpy(origins), extents, ramp)
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        ck.restore_windows(plane, torch.from_numpy(origins), extents,
                           ck.GradientRamp(ramp.values[:-1].contiguous(), horizontal))


def test_gradient_ramp_is_the_reference_canvas_and_c2_in_the_pad():
    for horizontal in (True, False):
        bg = _background(horizontal)
        c1, c2, hz = gradient_spec(torch.from_numpy(bg))
        ramp = ck.gradient_ramp(c1, c2, hz, (H, W), (H + 8, W + 96), "cpu")
        plane = ck._background_plane(ramp, 1, H + 8, W + 96, "cpu")[0]
        want = reference.background_canvas(bg, (W, H), "gradient")
        assert np.array_equal(ck.packed_to_u8(plane[:H, :W]).numpy(), want)
        pad = ck.packed_to_u8(plane[H:, W:]).numpy()
        assert (pad[..., :3] == np.array(c2, np.uint8)).all() and (pad[..., 3] == 255).all()


def test_an_upscale_past_asset_sized_bounds_renders_a_clamped_scale():
    """Pinned: a box larger than its object's bound renders the object at
    the size its window clamps the box to (the bound rounded up to 8 rows
    and 128 columns), anchored at the box's origin; the bounds of the output
    sizes render the box as the reference does."""
    objs = _objects(7)
    bg = _background(True)
    spec = gradient_spec(torch.from_numpy(bg))
    base = reference.background_canvas(bg, (W, H), "gradient")
    objects = _objects_by_id(objs)
    boxes = np.zeros((2, len(OBJ_HW), 4), np.int32)
    boxes[:] = [[2, 3, 22, 15], [30, 5, 44, 14], [60, 50, 68, 62], [90, 70, 107, 75]]
    boxes[0, 0] = [10, 20, 10 + 60, 20 + 36]  # object 0 (12 x 20) at 3x
    asset = make_gradient_render_step((H, W), tuple(map(tuple, OBJ_HW.tolist())), spec,
                                      reuse=False, device="cpu")
    plane, _ = asset(None, objs, np.broadcast_to(OBJ_HW, (2, *OBJ_HW.shape)), boxes)
    got = _crop(plane, 0).to(torch.int16)
    clamped = [(k, list(bx)) for k, bx in enumerate(boxes[0].tolist())]
    clamped[0][1][3] = 20 + 16  # the height cut to 12 rounded up to 8: 16; the width fits 128
    want = reference.compose(base, objects, clamped, "cpu").to(torch.int16)
    assert int((got - want).abs().max()) <= 1
    true = reference.compose(base, objects, list(enumerate(boxes[0].tolist())), "cpu")
    assert int((got - true.to(torch.int16)).abs().max()) > 16
    bounded = make_gradient_render_step((H, W), ((36, 60),) + tuple(map(tuple, OBJ_HW[1:].tolist())),
                                        spec, reuse=False, device="cpu")
    plane, _ = bounded(None, objs, np.broadcast_to(OBJ_HW, (2, *OBJ_HW.shape)), boxes)
    assert int((_crop(plane, 0).to(torch.int16) - true.to(torch.int16)).abs().max()) <= 1


@pytest.mark.parametrize("in_out", [(257, 1503), (137, 801), (357, 2088), (207, 1211),
                                    (62, 363), (32, 187), (20, 80), (9, 10)])
def test_k2_upscale_tables_stay_within_two_units_of_pillow(in_out):
    """K2's tables where a size grows: exact tap arguments keep every
    coefficient within 2 units of 2^22 of Pillow's (the float32 centre of
    the shrinking form is off by up to ~90 at these 5.85x upscales); the
    shrinking form is the traced one, unchanged."""
    from image_transformation_tpu_torch.ops.resize import build_coeffs_traced, build_coeffs_v3

    n_in, n_out = in_out
    ins, outs = torch.tensor([n_in, n_out]), torch.tensor([n_out, n_in])
    tables = build_coeffs_v3(ins, outs, max(in_out) + 5, max(in_out) + 3)
    up = tables[0, :n_out, :n_in].numpy().astype(np.int64)
    assert np.abs(up - reference.coefficients(n_in, n_out)).max() <= 2
    assert int(tables[0, n_out:].abs().sum()) == 0 and int(tables[0, :, n_in:].abs().sum()) == 0
    traced = build_coeffs_traced(ins, outs, max(in_out) + 5, max(in_out) + 3)
    assert torch.equal(tables[1], traced[1])


def test_gradient_step_checks_its_arguments():
    spec = ((1, 2, 3), (4, 5, 6), True)
    with pytest.raises(ValueError):
        make_gradient_render_step((H, W), ((12, 20),), spec, stat="mean", device="cpu")
    with pytest.raises(ValueError):
        make_gradient_render_step((H, W), ((0, 20),), spec, device="cpu")
    with pytest.raises(TypeError):  # an RGBA tuple is neither a packed colour nor a ramp
        ck.render_fused_v3_reuse_program(
            torch.zeros((1, 96, 256), dtype=torch.int32), np.zeros((1, 1, 4)),
            ck.planarize_objects(torch.from_numpy(_objects(1)[:, :1])), np.array([[[12, 20]]]),
            np.zeros((1, 1, 4)), (H, W), (1, 2, 3, 255))
    assert make_solid_render_step.__doc__ and "bounds" in make_solid_render_step.__doc__
