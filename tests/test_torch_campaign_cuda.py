"""A campaign batch on the card: K3's ramp form with a line per canvas, its
shared-line launch, the gradient step at the campaign cell's shapes with
each canvas's own creative and gradient, and empty slots, against their
plain versions, tolerance 0.

Every test here is marked ``cuda`` and skips without a card:
``python -m pytest tests/test_torch_campaign_cuda.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch

from bench_torch import harness, reference
from bench_torch.drivers import campaign, score_up
from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.ops.background import gradient_spec
from image_transformation_tpu_torch.parallel import make_gradient_render_step


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 and K3 have no CPU mode")
    return torch.device("cuda", 0)


def _ints(rng, shape):
    return torch.from_numpy(rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32))


def _cut_windows(rng, B, N, hp, wp, top):
    """Extents and origins past every edge of the plane, overlapping, narrower
    than a 16-byte group."""
    ext = tuple((int(h), int(w)) for h, w in zip(rng.integers(1, top, N), rng.integers(1, top, N)))
    origins = rng.integers(-top, max(hp, wp) + 8, (B, N, 2)).astype(np.int32)
    origins[0, 0] = (wp - 2, hp - 3)
    origins[-1, -1] = (-5, -9)
    return ext, torch.from_numpy(origins)


@pytest.mark.cuda
@pytest.mark.parametrize("horizontal", [True, False], ids=["horizontal", "vertical"])
def test_k3_line_form_matches_plain_version(cuda, horizontal):
    """A line per canvas, at cut windows, the campaign's 4:1 plane, and rows
    that start 4 bytes past a 16-byte boundary."""
    rng = np.random.default_rng(31)
    ck.reset_launch_counts()
    launches = 0
    for B, N, hp, wp, top in ((3, 6, 64, 384, 80), (4, 4, 1440, 5760, 1400), (5, 40, 96, 260, 90)):
        plane = _ints(rng, (B, hp, wp))
        ramp = ck.GradientRamp(_ints(rng, (B, wp if horizontal else hp)), horizontal)
        ext, origins = _cut_windows(rng, B, N, hp, wp, top)
        want = ck.restore_windows_reference(plane.clone(), origins, ext, ramp)
        got = ck.restore_windows(plane.to(cuda), origins.to(cuda), ext,
                                 ck.GradientRamp(ramp.values.to(cuda), horizontal))
        launches += 1
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (B, N, hp, wp)
    base = _ints(rng, (2 * 64 * 260 + 1,))
    plane = base[1:].view(2, 64, 260)
    ramp = ck.GradientRamp(_ints(rng, (2, 260 if horizontal else 64)), horizontal)
    origins = torch.from_numpy(rng.integers(-20, 250, (2, 5, 2)).astype(np.int32))
    ext = ((30, 101), (7, 3), (64, 260), (1, 1), (12, 40))
    want = ck.restore_windows_reference(plane.clone(), origins, ext, ramp)
    got = ck.restore_windows(base.to(cuda)[1:].view(2, 64, 260), origins.to(cuda), ext,
                             ck.GradientRamp(ramp.values.to(cuda), horizontal))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert ck.LAUNCHES["restore_windows_lines"] == ck.LAUNCHES["restore_windows"] == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("horizontal", [True, False], ids=["horizontal", "vertical"])
def test_k3_shared_line_launch_is_unchanged(cuda, horizontal):
    """One line == its plain version, == the same line given per canvas, and
    not counted as a line-per-canvas launch."""
    rng = np.random.default_rng(32)
    B, N, hp, wp = 4, 5, 3840, 2304
    plane = _ints(rng, (B, hp, wp))
    line = _ints(rng, wp if horizontal else hp)
    ext, origins = _cut_windows(rng, B, N, hp, wp, 2400)
    want = ck.restore_windows_reference(plane.clone(), origins, ext, ck.GradientRamp(line, horizontal))
    ck.reset_launch_counts()
    shared = ck.restore_windows(plane.to(cuda), origins.to(cuda), ext,
                                ck.GradientRamp(line.to(cuda), horizontal))
    assert ck.LAUNCHES["restore_windows"] == 1 and ck.LAUNCHES["restore_windows_lines"] == 0
    lines = line.to(cuda).expand(B, line.shape[0]).contiguous()
    spread = ck.restore_windows(plane.to(cuda), origins.to(cuda), ext,
                                ck.GradientRamp(lines, horizontal))
    torch.cuda.synchronize()
    assert torch.equal(shared.cpu(), want) and torch.equal(spread, shared)
    assert ck.LAUNCHES["restore_windows_lines"] == 1


def _cell_inputs(B, device):
    """The campaign cell's inputs for a batch of B: per canvas b bundle b % 2's
    planar objects, sizes and gradient; the level sizes; the canvases."""
    cell = harness.load_cell("campaign_uhd.sweep4x64")
    cfg, mix = cell.config, cell.mix
    canvases = [reference.canvas_size(tuple(cfg["pixel_budget_wh"]), r)[::-1] for r in mix["ratios"]]
    bundles = [load_bundle(harness.CHECKOUT / p) for p in cfg["bundles"]]
    pad = (max(m.height for b in bundles for m in b.meta.values()),
           max(m.width for b in bundles for m in b.meta.values()))
    arrays = [b.to_arrays(n_max=4, pad_hw=pad) for b in bundles]
    levels = score_up.scale_levels(tuple(cfg["pixel_budget_wh"][::-1]), cfg["original_wh"],
                                   mix["scale_levels"], mix["scale_range"])
    sizes = [score_up.level_sizes(a.obj_hw[:len(b.meta)], levels) for a, b in zip(arrays, bundles)]
    objs_p = ck.planarize_objects(torch.from_numpy(
        np.stack([arrays[b % 2].objects for b in range(B)])).to(device))
    hw = torch.from_numpy(np.stack([arrays[b % 2].obj_hw for b in range(B)])).to(device)
    specs = [gradient_spec(torch.from_numpy(np.asarray(b.background, np.uint8).copy()))
             for b in bundles]
    gradient = (np.array([specs[b % 2][0] for b in range(B)], np.uint8),
                np.array([specs[b % 2][1] for b in range(B)], np.uint8),
                [specs[b % 2][2] for b in range(B)])
    return canvases, sizes, objs_p, hw, gradient


@pytest.mark.cuda
def test_the_campaign_step_at_the_cells_shapes_matches_the_plain_path(cuda, monkeypatch):
    """B = 8 at 9:16, 1:1, 16:9 and 4:1, steps interleaved: a fresh render and
    three reuse renders each; each ratio's last plane == a plain render of its
    last boxes on a fresh gradient plane (by slices of 2 canvases), and the
    lumas == the plain luma."""
    B, reuse = 8, 3
    canvases, sizes, objs_p, hw, gradient = _cell_inputs(B, cuda)
    rng = np.random.default_rng(33)
    steps, geos, last = [], [], {}
    for hw_c in canvases:
        bounds = campaign.ratio_bounds(sizes, 4, hw_c)
        steps.append(make_gradient_render_step(hw_c, bounds, gradient, device="cuda"))
        geos.append(ck.render_geometry(hw_c, (max(h for h, _ in bounds), max(w for _, w in bounds)),
                                       4, bounds, pipelined=True))
    ck.reset_launch_counts()
    for i in range(reuse + 1):
        for r, hw_c in enumerate(canvases):
            boxes = torch.from_numpy(campaign.campaign_boxes(rng, sizes, 4, hw_c, B)).to(cuda)
            plane, luma = steps[r](None, objs_p, hw, boxes)
            last[r] = (plane, luma, boxes)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["restore_windows_lines"] == ck.LAUNCHES["restore_windows"] == 4 * reuse
    assert ck.LAUNCHES["fused_v3_own_objects"] == ck.LAUNCHES["fused_v3_chunks"] > 0
    for r, (plane, luma, boxes) in last.items():
        geo = geos[r]
        ramp = ck.gradient_ramp(*gradient, canvases[r], geo.pad, cuda)
        meta = geo.meta(hw, boxes)
        for b0 in range(0, B, 2):
            part = ck._background_plane(ck.GradientRamp(ramp.values[b0:b0 + 2], True), 2,
                                        *geo.pad, cuda)
            ck.fused_v3_reference(part, objs_p[b0:b0 + 2], meta[b0:b0 + 2], geo.envelope)
            assert torch.equal(part, plane[b0:b0 + 2]), (canvases[r], b0)
        H, W = canvases[r]
        assert torch.equal(luma, ck.packed_luma_reference(plane[:, :H, :W]))


@pytest.mark.cuda
def test_an_empty_slot_walks_no_tile(cuda):
    """audio_book's empty fourth slot, given an opaque source and a box over the
    canvas: no live tile in the card's meta, no more resample walks than
    chunks, and K2 == its plain version."""
    B = 4
    canvases, sizes, objs_p, hw, gradient = _cell_inputs(B, cuda)
    objs_p = objs_p.clone()
    objs_p[1::2, 3] = 255  # the empty slot's source: opaque, never to be drawn
    H, W = canvases[2]
    bounds = campaign.ratio_bounds(sizes, 4, (H, W))
    env = (max(h for h, _ in bounds), max(w for _, w in bounds))
    geo = ck.render_geometry((H, W), env, 4, bounds, pipelined=True)
    boxes = torch.from_numpy(campaign.campaign_boxes(np.random.default_rng(34), sizes, 4, (H, W),
                                                     B)).to(cuda)
    boxes[1::2, 3] = torch.tensor([16, 8, 16 + bounds[3][1], 8 + bounds[3][0]], device=cuda)
    meta = geo.meta(hw, boxes)
    tiles = ck._v3_live_tiles(meta, geo.envelope)
    assert int(tiles[1::2, 3].sum()) == 0 and int(tiles[0::2, 3].min()) > 0
    assert bool((meta[1::2, 3, :2] == torch.tensor([geo.pad[1], geo.pad[0]], device=cuda)).all())
    ramp = ck.gradient_ramp(*gradient, (H, W), geo.pad, cuda)
    plane = ck._background_plane(ramp, B, *geo.pad, cuda)
    want = ck.fused_v3_reference(plane.clone(), objs_p, meta, geo.envelope)
    ck.reset_launch_counts()
    got = ck.fused_v3(plane, objs_p, meta, geo.envelope)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ck.LAUNCHES["fused_v3_walks"] == ck.LAUNCHES["fused_v3_chunks"] == 1
    assert ck.LAUNCHES["fused_v3_own_objects"] == 1
