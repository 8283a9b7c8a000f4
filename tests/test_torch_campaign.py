"""A campaign batch on the gradient step, on the CPU (the plain versions of
K2 and of K3's ramp form): each canvas with its own creative's cutouts
(objects [B, N, ...]), its own gradient (a ramp line per canvas) and its own
object count (a creative with fewer cutouts than the batch's slots leaves
empty slots of size (0, 0)), and steps of several ratios interleaved.

K3's plain version fills each canvas's windows from its own line; one line
for the batch restores as before. Gradients on both axes, or a count of
lines other than the batch's, raise. Two seeded creatives of 3 and 4
binary-alpha cutouts alternate canvas by canvas, upscaled 1.5-3x: a fresh
step and three reuse steps equal the benchmark's plain reference
(``bench_torch.reference``) and Pillow within 2 on the boxes (the
exact-argument tables, as ``tests/test_torch_gradient_step.py`` sets out)
and exactly off them. An empty slot is not valid, its window's origin lies
past the plane, and it changes no pixel, restores nothing, walks no tile
and takes no table entry.
"""

import numpy as np
import pytest
import torch

from bench_torch import reference
from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.ops.background import gradient_spec
from image_transformation_tpu_torch.parallel import make_gradient_render_step

H, W = 96, 160
PAD = (12, 20)
#: the two creatives' cutouts (h, w): 3 and 4, so the first leaves slot 3 empty
CREATIVES = ([[10, 14], [7, 18], [12, 9]], [[12, 20], [9, 14], [12, 8], [5, 17]])
N = 4
B, STEPS = 4, 4
SCALE = (1.5, 3.0)


def _cutouts(seed):
    """Per creative, u8 [N, 12, 20, 4] zero past each cutout (and in its
    empty slots), binary alpha; and its sizes int32 [N, 2]."""
    rng = np.random.default_rng(seed)
    out = []
    for sizes in CREATIVES:
        objs = np.zeros((N, *PAD, 4), np.uint8)
        hw = np.zeros((N, 2), np.int32)
        for k, (h, w) in enumerate(sizes):
            px = rng.integers(0, 256, (h, w, 4))
            px[..., 3] = np.where(px[..., 3] > 96, 255, 0)
            objs[k, :h, :w] = px
            hw[k] = (h, w)
        out.append((objs, hw))
    return out


def _background(i, horizontal):
    """Creative i's background image, whose upstream gradient runs along
    ``horizontal``'s axis with colours of its own."""
    y, x = np.mgrid[0:40, 0:60]
    along, across = (x / 59, y / 39) if horizontal else (y / 39, x / 59)
    base = np.array([[180, 40, 70], [30, 200, 120]][i])
    rgb = (base + along[..., None] * np.array([[-60, 90, 40], [120, -70, 60]][i])
           + across[..., None] * np.array([70, 120, -60]) * (2 * (across[..., None] > 0.5) - 1))
    bg = np.full((40, 60, 4), 255, np.uint8)
    bg[..., :3] = np.clip(rgb, 0, 255).astype(np.uint8)
    return bg


def _gradients(horizontal, batch=B):
    """(c1 [B, 3], c2 [B, 3], axes [B]) of canvas b's creative b % 2, and the
    two background images."""
    images = [_background(i, horizontal) for i in range(2)]
    specs = [gradient_spec(torch.from_numpy(im)) for im in images]
    c1 = np.array([specs[b % 2][0] for b in range(batch)], np.uint8)
    c2 = np.array([specs[b % 2][1] for b in range(batch)], np.uint8)
    return (c1, c2, [specs[b % 2][2] for b in range(batch)]), images


def _box_sets(seed, canvas_hw=(H, W), steps=STEPS, batch=B):
    """int32 [steps, batch, N, 4]: canvas b's creative b % 2, each cutout at a
    scale of 1.5-3x, the whole box inside the canvas; empty slots (0, 0, 0, 0)."""
    rng = np.random.default_rng(seed)
    h_c, w_c = canvas_hw
    out = np.zeros((steps, batch, N, 4), np.int32)
    for i in range(steps):
        for b in range(batch):
            for k, (h, w) in enumerate(CREATIVES[b % 2]):
                s = rng.uniform(*SCALE)
                bw, bh = max(1, round(w * s)), max(1, round(h * s))
                x, y = rng.integers(0, w_c - bw + 1), rng.integers(0, h_c - bh + 1)
                out[i, b, k] = (x, y, x + bw, y + bh)
    return out


def _bounds():
    return tuple((max(round(c[k][0] * SCALE[1]) for c in CREATIVES if k < len(c)),
                  max(round(c[k][1] * SCALE[1]) for c in CREATIVES if k < len(c)))
                 for k in range(N))


def _batch(cutouts, batch=B):
    """(planar objects [B, N, 4, ...], sizes [B, N, 2]) of canvas b's creative b % 2."""
    objs = np.stack([cutouts[b % 2][0] for b in range(batch)])
    hw = np.stack([cutouts[b % 2][1] for b in range(batch)])
    return ck.planarize_objects(torch.from_numpy(objs)), hw


def _rand_i32(rng, shape):
    return torch.from_numpy(rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32))


# K3's plain version with a line per canvas ---------------------------------------------

@pytest.mark.parametrize("horizontal", [True, False], ids=["horizontal", "vertical"])
def test_k3_plain_version_fills_each_canvas_from_its_own_line(horizontal):
    rng = np.random.default_rng(3)
    b_, hp, wp = 3, 48, 256
    n = wp if horizontal else hp
    plane = _rand_i32(rng, (b_, hp, wp))
    lines = _rand_i32(rng, (b_, n))
    origins = torch.from_numpy(rng.integers(-20, 240, (b_, 3, 2)).astype(np.int32))
    ext = ((16, 60), (40, 130), (5, 3))
    got = ck.restore_windows_reference(plane.clone(), origins, ext, ck.GradientRamp(lines, horizontal))
    want = plane.clone()
    for b in range(b_):
        for k, (x, y) in enumerate(origins[b].tolist()):
            h, w = ext[k]
            ys, xs = slice(max(y, 0), max(y + h, 0)), slice(max(x, 0), max(x + w, 0))
            want[b, ys, xs] = lines[b][xs][None, :] if horizontal else lines[b][ys][:, None]
    assert torch.equal(got, want)
    # one line for the batch restores as a line per canvas of that line
    shared = ck.restore_windows_reference(plane.clone(), origins, ext,
                                          ck.GradientRamp(lines[1], horizontal))
    spread = ck.restore_windows_reference(plane.clone(), origins, ext,
                                          ck.GradientRamp(lines[1].expand(b_, n).contiguous(),
                                                          horizontal))
    assert torch.equal(shared, spread) and torch.equal(shared[1], got[1])
    assert not torch.equal(shared, got)


@pytest.mark.parametrize("horizontal", [True, False], ids=["horizontal", "vertical"])
def test_a_shared_line_restores_what_it_restored_before(horizontal):
    """[n] lines: a direct fill of each window with the one line's values."""
    rng = np.random.default_rng(4)
    plane = _rand_i32(rng, (2, 40, 256))
    line = _rand_i32(rng, 256 if horizontal else 40)
    origins = torch.tensor([[[3, 5], [250, 38]], [[-7, -2], [120, 10]]], dtype=torch.int32)
    ext = ((9, 40), (7, 30))
    got = ck.restore_windows(plane.clone(), origins, ext, ck.GradientRamp(line, horizontal))
    want = plane.clone()
    for b, row in enumerate(origins.tolist()):
        for (x, y), (h, w) in zip(row, ext):
            for yy in range(max(y, 0), min(y + h, 40)):
                for xx in range(max(x, 0), min(x + w, 256)):
                    want[b, yy, xx] = line[xx if horizontal else yy]
    assert torch.equal(got, want)


# what raises -----------------------------------------------------------------------------

def _raises_mixed_axes_in_the_step():
    (c1, c2, _), _ = _gradients(True)
    make_gradient_render_step((H, W), _bounds(), (c1, c2, [True, False, True, True]),
                              device="cpu")


def _raises_mixed_axes_in_the_ramp():
    ck.gradient_ramp(np.zeros((2, 3)), np.ones((2, 3)), np.array([False, True]), (H, W),
                     (H, 256), "cpu")


def _raises_too_few_lines_in_k3():
    plane = torch.zeros((3, 8, 128), dtype=torch.int32)
    ramp = ck.GradientRamp(torch.zeros((2, 128), dtype=torch.int32), True)
    ck.restore_windows(plane, torch.zeros((3, 1, 2), dtype=torch.int32), ((8, 8),), ramp)


def _raises_more_lines_than_canvases_in_the_step():
    (c1, c2, axes), _ = _gradients(True, batch=B + 1)
    step = make_gradient_render_step((H, W), _bounds(), (c1, c2, axes), device="cpu")
    objs_p, hw = _batch(_cutouts(1))
    step(None, objs_p, hw, _box_sets(2)[0])


@pytest.mark.parametrize("call", [_raises_mixed_axes_in_the_step, _raises_mixed_axes_in_the_ramp,
                                  _raises_too_few_lines_in_k3,
                                  _raises_more_lines_than_canvases_in_the_step],
                         ids=["mixed-axes-step", "mixed-axes-ramp", "k3-lines-not-B",
                              "step-lines-not-B"])
def test_mixed_axes_and_a_line_count_other_than_the_batch_raise(call):
    with pytest.raises(ValueError) as err:
        call()
    msg = str(err.value)
    assert ("both axes" in msg) if "axes" in call.__name__ else ("line" in msg)


# a campaign chain against the reference and Pillow --------------------------------------

def _pil(image_bg, cutouts, boxes, wh):
    """Pillow's own compose: the reference's fill_gradient canvas, each
    cutout resized with LANCZOS and alpha-composited in slot order."""
    from PIL import Image

    canvas = Image.fromarray(reference.background_canvas(image_bg, wh, "gradient"))
    objs, hw = cutouts
    for k, (h, w) in enumerate(hw.tolist()):
        if h == 0:
            continue
        x1, y1, x2, y2 = boxes[k].tolist()
        obj = Image.fromarray(np.ascontiguousarray(objs[k, :h, :w]))
        canvas.alpha_composite(obj.resize((x2 - x1, y2 - y1), Image.LANCZOS), (x1, y1))
    return np.asarray(canvas)


@pytest.mark.parametrize("horizontal", [True, False], ids=["horizontal", "vertical"])
def test_a_campaign_chain_equals_the_reference_and_pillow(horizontal):
    cutouts = _cutouts(5)
    objs_p, hw = _batch(cutouts)
    gradient, images = _gradients(horizontal)
    assert set(gradient[2]) == {horizontal}
    step = make_gradient_render_step((H, W), _bounds(), gradient, device="cpu")
    sets = _box_sets(6)
    for i, boxes in enumerate(sets):  # a fresh step, then reuse steps
        plane, luma = step(None, objs_p, hw, boxes)
        for b in range(B):
            objs, sizes = cutouts[b % 2]
            got = ck.packed_to_u8(plane[b, :H, :W]).to(torch.int16)
            base = reference.background_canvas(images[b % 2], (W, H), "gradient")
            live = [k for k in range(N) if sizes[k, 0] > 0]
            placements = [(k, boxes[b, k].tolist()) for k in live]
            ref = reference.compose(base, {k: np.ascontiguousarray(objs[k, :sizes[k, 0], :sizes[k, 1]])
                                           for k in live}, placements, "cpu").to(torch.int16)
            pil = torch.from_numpy(_pil(images[b % 2], cutouts[b % 2], boxes[b], (W, H)).copy())
            off = torch.ones((H, W), dtype=torch.bool)
            for _, (x1, y1, x2, y2) in placements:
                off[y1:y2, x1:x2] = False
            assert off.any() and torch.equal(got[off], torch.from_numpy(base).to(torch.int16)[off])
            assert int((got - ref).abs().max()) <= 2, (i, b)
            assert int((got - pil.to(torch.int16)).abs().max()) <= 2, (i, b)
            assert torch.equal(ref, pil.to(torch.int16))
            assert abs(float(luma[b]) - reference.luma(got.to(torch.uint8))) < 1e-3


# empty slots ---------------------------------------------------------------------------------

def _with_and_without_the_empty_slot(seed=7):
    """(geometry, objs_p, hw, boxes) of a batch whose canvas 0 has an empty
    slot 3 with a box over the canvas, and the same batch with slot 3 of
    canvas 0 moved off the canvas (a drop), so that it draws nothing."""
    cutouts = _cutouts(seed)
    objs_p, hw = _batch(cutouts, 2)
    boxes = _box_sets(seed + 1, steps=1, batch=2)[0]
    boxes[0, 3] = (5, 7, 60, 40)  # an empty slot's box covers other boxes' pixels
    geo = ck.render_geometry((H, W), (36, 60), N, _bounds(), pipelined=True)
    return geo, objs_p, hw, boxes


def test_an_empty_slot_is_not_valid_and_its_window_lies_past_the_plane():
    geo, objs_p, hw, boxes = _with_and_without_the_empty_slot()
    meta = geo.meta(hw, boxes)
    hp, wp = geo.pad
    assert meta[0, 3, :6].tolist() == [wp, hp, 0, 0, 0, 0]
    assert int(meta[1, 3, 5]) == 1
    assert bool((meta[..., 5][torch.from_numpy(hw.min(-1) > 0)] == 1).all())
    assert int(ck._v3_live_tiles(meta, geo.envelope)[0, 3]) == 0
    tables = ck.fused_v3_tables_reference(meta, tuple(objs_p.shape[3:]), geo.envelope)
    assert int(tables[0, 3].abs().sum()) == 0 and int(tables[1, 3].abs().sum()) > 0


def test_an_empty_slot_changes_no_pixel():
    geo, objs_p, hw, boxes = _with_and_without_the_empty_slot()
    (c1, c2, axes), _ = _gradients(True, batch=2)
    ramp = ck.gradient_ramp(c1, c2, axes, (H, W), geo.pad, "cpu")
    got, _ = ck.render_fused_v3_step(geo, objs_p, hw, boxes, ramp)
    moved = boxes.copy()
    moved[0, 3] = (-1, -1, 0, 0)
    want, _ = ck.render_fused_v3_step(geo, objs_p, hw, moved, ramp)
    assert torch.equal(got, want)
    # and canvas 0 equals a render of its three cutouts alone
    geo3 = ck.render_geometry((H, W), geo.envelope, 3, _bounds()[:3], pipelined=True)
    alone, _ = ck.render_fused_v3_step(geo3, objs_p[:1, :3].contiguous(), hw[:1, :3],
                                       boxes[:1, :3], ck.GradientRamp(ramp.values[:1], True))
    assert torch.equal(got[:1], alone)


def test_an_empty_slot_restores_nothing():
    geo, objs_p, hw, boxes = _with_and_without_the_empty_slot()
    meta = geo.meta(hw, boxes)
    origins = meta[..., :2].contiguous()
    rng = np.random.default_rng(9)
    plane = _rand_i32(rng, (2, *geo.pad))
    ramp = ck.GradientRamp(_rand_i32(rng, (2, geo.pad[1])), True)
    got = ck.restore_windows(plane.clone(), origins, geo.windows, ramp)
    # canvas 0 as a restore of its three cutouts' windows alone, canvas 1 of all four
    alone = ck.restore_windows(plane[:1].clone(), origins[:1, :3].contiguous(), geo.windows[:3],
                               ck.GradientRamp(ramp.values[:1], True))
    assert torch.equal(got[:1], alone) and not torch.equal(got[1], plane[1])
    # where the empty slot's window took its box's origin, the restore would write there
    at_box = origins.clone()
    at_box[0, 3] = torch.tensor([0, 0], dtype=torch.int32)
    assert not torch.equal(ck.restore_windows(plane.clone(), at_box, geo.windows, ramp)[0], got[0])


def test_a_reuse_step_after_an_empty_slot_equals_a_fresh_render():
    geo, objs_p, hw, boxes = _with_and_without_the_empty_slot()
    (c1, c2, axes), _ = _gradients(False, batch=2)
    ramp = ck.gradient_ramp(c1, c2, axes, (H, W), geo.pad, "cpu")
    nxt = _box_sets(21, steps=1, batch=2)[0]
    nxt[0, 3] = (0, 0, 90, 50)
    plane, meta = ck.render_fused_v3_step(geo, objs_p, hw, boxes, ramp)
    plane, _ = ck.render_fused_v3_step(geo, objs_p, hw, nxt, ramp, (plane, meta))
    fresh, _ = ck.render_fused_v3_step(geo, objs_p, hw, nxt, ramp)
    assert torch.equal(plane, fresh)


# ratios interleaved -----------------------------------------------------------------------------

def test_four_ratio_steps_interleaved_keep_their_own_planes():
    """Steps at four canvas shapes of about one pixel count, called in turn,
    each reuse call equal to a fresh render of its own boxes."""
    shapes = [(128, 72), (96, 96), (72, 128), (48, 192)]
    cutouts = _cutouts(11)
    objs_p, hw = _batch(cutouts)
    gradient, _ = _gradients(True)
    steps = [make_gradient_render_step(s, _bounds(), gradient, device="cpu") for s in shapes]
    fresh = [make_gradient_render_step(s, _bounds(), gradient, reuse=False, device="cpu")
             for s in shapes]
    sets = [_box_sets(30 + r, canvas_hw=s, steps=3) for r, s in enumerate(shapes)]
    planes = {}
    for i in range(3):
        for r, s in enumerate(shapes):
            plane, _ = steps[r](None, objs_p, hw, sets[r][i])
            if i == 0:
                planes[r] = plane
            assert plane.data_ptr() == planes[r].data_ptr()
            want, _ = fresh[r](None, objs_p, hw, sets[r][i])
            assert torch.equal(plane, want), (i, s)
