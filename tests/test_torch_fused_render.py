"""The port's multi-ratio fused render (pipeline/fused.py) against the JAX
package's (CPU backend) and against PIL.

The same bundle arrays go through JAX's make_fused_render ("xla", and
"pallas" with the gen-3 kernel in interpret mode) and the port's ("xla",
and "pallas", which on CPU tensors runs K2's plain version). Tolerances:

- boxes and scales: equal (the tensor solver is bit-exact);
- pixels: at most 1 (of 255) anywhere in the padded renders, JAX's own
  cross-program envelope (tests/test_fused_render.py:106,212);
- luma: within 1.0 across programs (a mean moves by at most the largest
  pixel difference), and within rtol 1e-5 of JAX's packed_luma_masked on
  the same plane (float32 reductions in another order);
- against PIL: at most 2/255, the traced-table contract, with boxes equal
  to the host oracle layout/flex.solve_flex.
"""

import types

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from image_transformation_tpu.layout.solve import FlexProgram as JaxProgram
from image_transformation_tpu.ops.compose_pallas import packed_luma_masked as jax_luma_masked
from image_transformation_tpu.pipeline import fused as jf
from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.layout.canvas import compute_canvas_size
from image_transformation_tpu_torch.layout.flex import solve_flex
from image_transformation_tpu_torch.layout.solve import FlexProgram
from image_transformation_tpu_torch.ops.background import gradient_canvas
from image_transformation_tpu_torch.ops.compose_kernels import packed_luma_masked
from image_transformation_tpu_torch.pipeline import fused
from image_transformation_tpu_torch.pipeline import fused_multi_ratio_render, make_fused_render

RATIOS = ["9:16", "1:1", "16:9", "4:1"]


def _layout_for(bundle):
    return {"type": "flex", "direction": "column", "children": [
        {"object_id": oid, "name": bundle.meta[oid].label} for oid in bundle.object_ids()]}


def _setup(bundle_name, ratios, background):
    """(bundle, root, sizes, canvas_max_hw, obj_pad, port args, JAX args,
    gradient_horizontal)."""
    bundle = load_bundle(f"data/{bundle_name}")
    root = _layout_for(bundle)
    sizes = [compute_canvas_size(bundle.background.size, r, verbose=False) for r in ratios]
    canvas_max = (max(h for _, h in sizes), max(w for w, _ in sizes))
    arrays = bundle.to_arrays()
    prog = FlexProgram.from_dsl(root)
    objs, obj_wh, known = fused.map_bundle_to_program(prog, bundle, arrays)
    bg_np = np.array(bundle.background)
    bg, horizontal = fused.background_spec(torch.from_numpy(bg_np), background)
    jbg, jhorizontal = jf.background_spec(jnp.asarray(bg_np), background)
    assert horizontal == jhorizontal and np.array_equal(bg.numpy(), np.asarray(jbg))
    wh = np.asarray(sizes, np.int32)
    port = (torch.from_numpy(wh), bg, torch.from_numpy(objs), torch.from_numpy(obj_wh),
            torch.from_numpy(known))
    jax_args = (jnp.asarray(wh), jbg, jnp.asarray(objs), jnp.asarray(obj_wh),
                jnp.asarray(known))
    return (bundle, root, sizes, canvas_max, arrays.objects.shape[1:3], port, jax_args,
            horizontal)


def _plane(out_u8):
    return out_u8.contiguous().view(torch.int32).squeeze(-1)


@pytest.mark.parametrize("background", ["solid", "gradient"])
def test_both_kernels_match_jax(background):
    bundle, root, sizes, canvas_max, pad, args, jargs, horizontal = _setup(
        "squarespace", ["9:16", "16:9"], background)
    kw = dict(background=background, gradient_horizontal=horizontal)
    jprog = JaxProgram.from_dsl(root)
    want = {
        "xla": jf.make_fused_render(jprog, canvas_max, pad, **kw)(*jargs),
        "pallas": jf.make_fused_render(jprog, canvas_max, pad, kernel="pallas",
                                       interpret=True, **kw)(*jargs),
    }
    prog = FlexProgram.from_dsl(root)
    got = {k: make_fused_render(prog, canvas_max, pad, kernel=k, **kw)(*args)
           for k in ("xla", "pallas")}
    ref_boxes, ref_scales = np.asarray(want["xla"][1]), np.asarray(want["xla"][2])
    for kernel in ("xla", "pallas"):
        out, boxes, scales, luma = got[kernel]
        assert out.dtype == torch.uint8 and out.shape == (2, *canvas_max, 4)
        assert np.array_equal(boxes.numpy(), ref_boxes)
        assert np.array_equal(scales.numpy(), ref_scales)
        assert np.array_equal(np.asarray(want[kernel][1]), ref_boxes)
        for other in ("xla", "pallas"):
            d = np.abs(out.numpy().astype(int) - np.asarray(want[other][0]).astype(int))
            assert d.max() <= 1, (kernel, other, d.max())
            assert np.allclose(luma.numpy(), np.asarray(want[other][3]), atol=1.0)
        # the statistic itself: JAX's masked luma of the port's own plane
        jl = np.asarray(jax_luma_masked(jnp.asarray(_plane(out).numpy()), jargs[0]))
        np.testing.assert_allclose(luma.numpy(), jl, rtol=1e-5)
    assert torch.equal(got["xla"][0], got["pallas"][0])  # one plain compose, bit for bit

    out_np, boxes_np = got["pallas"][0].numpy(), got["pallas"][1].numpy()
    for i, (w, h) in enumerate(sizes):
        crop = out_np[i, :h, :w]
        covered = np.zeros((h, w), bool)
        for x1, y1, x2, y2 in boxes_np[i]:
            covered[max(0, y1):max(0, y2), max(0, x1):max(0, x2)] = True
        assert (crop[..., 3] == 255).all()
        if background == "gradient":
            # the uncovered background: the per-request ramp within 1
            c1, c2 = args[1].tolist()
            ramp = gradient_canvas(np.array(c1, np.uint8), np.array(c2, np.uint8), h, w,
                                   horizontal, torch.device("cpu")).numpy()
            d = np.abs(crop[~covered].astype(int) - ramp[~covered].astype(int))
            assert d.max() <= 1, (i, d.max())
            jcrop = np.asarray(want["pallas"][0])[i, :h, :w]
            d = np.abs(crop[~covered].astype(int) - jcrop[~covered].astype(int))
            assert d.max() <= 1


def _pil_render(bundle, root, ratio):
    """The reference's compose: the median colour of the background's
    non-transparent pixels, then LANCZOS resize + alpha_composite."""
    W, H = compute_canvas_size(bundle.background.size, ratio, verbose=False)
    bg = np.asarray(bundle.background.convert("RGBA"))
    px = bg[bg[..., 3] > 0][:, :3]
    color = tuple(int(np.median(px[:, c])) for c in range(3))
    out = Image.new("RGBA", (W, H), color + (255,))
    placements = solve_flex(root, (W, H), bundle.sizes())
    for p in placements:
        x1, y1, x2, y2 = p["box"]
        w, h = max(1, x2 - x1), max(1, y2 - y1)
        out.alpha_composite(bundle.objects[int(p["object_id"])].resize((w, h), Image.LANCZOS),
                            dest=(x1, y1))
    return np.asarray(out), placements


@pytest.mark.parametrize("bundle_name", ["audio_book", "squarespace"])
def test_multi_ratio_render_matches_pil(bundle_name):
    bundle = load_bundle(f"data/{bundle_name}")
    root = _layout_for(bundle)
    renders, solved = fused_multi_ratio_render(bundle, root, RATIOS, device="cpu")
    for ratio in RATIOS:
        ref, placements = _pil_render(bundle, root, ratio)
        got = renders[ratio]
        assert got.shape == ref.shape, ratio
        for k, p in enumerate(placements):
            assert solved[ratio][k].tolist() == p["box"], (ratio, k)
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 2, ratio


def test_packed_luma_masked_matches_jax():
    rng = np.random.default_rng(3)
    plane = rng.integers(-(1 << 31), 1 << 31, (5, 67, 301), dtype=np.int64).astype(np.int32)
    wh = np.array([[301, 67], [1, 1], [120, 40], [300, 66], [17, 60]], np.int32)
    got = packed_luma_masked(torch.from_numpy(plane), torch.from_numpy(wh))
    want = np.asarray(jax_luma_masked(jnp.asarray(plane), jnp.asarray(wh)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # a strided crop of a larger plane reads only its own pixels
    big = torch.from_numpy(rng.integers(0, 1 << 30, (5, 80, 320)).astype(np.int32))
    big[:, :67, :301] = torch.from_numpy(plane)
    crop = packed_luma_masked(big[:, :67, :301], torch.from_numpy(wh))
    assert torch.equal(crop, got)


def test_host_helpers_equal_jax():
    bundle = load_bundle("data/squarespace")
    arrays = bundle.to_arrays()
    root = _layout_for(bundle)
    root["children"].append({"object_id": 99, "name": "missing"})
    got = fused.map_bundle_to_program(FlexProgram.from_dsl(root), bundle, arrays)
    want = jf.map_bundle_to_program(JaxProgram.from_dsl(root), bundle, arrays)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert not got[2][-1]
    for v, m in ((3, 8), (8, 8), (9, 4), (1, 1)):
        wh = np.arange(2 * v, dtype=np.int32).reshape(v, 2)
        for a, b in zip(fused.pad_ragged_variants(wh, m), jf.pad_ragged_variants(wh, m)):
            assert np.array_equal(a, b)


def test_options_and_missing_card_raise(monkeypatch):
    bundle = load_bundle("data/squarespace")
    prog = FlexProgram.from_dsl(_layout_for(bundle))
    # canvas rows that do not divide over the mesh's spatial ranks (the
    # sharded step itself: tests/test_torch_mesh.py)
    three = types.SimpleNamespace(size=lambda axes=None: 3)
    with pytest.raises(ValueError, match="divisible"):
        fused.make_sharded_fused_render(three, prog, (10, 10), (4, 4), spatial=True)
    with pytest.raises(ValueError, match="kernel"):
        make_fused_render(prog, (10, 10), (4, 4), kernel="mosaic")
    with pytest.raises(ValueError, match="background"):
        make_fused_render(prog, (10, 10), (4, 4), background="plaid")
    with pytest.raises(ValueError, match="static_obj_hw"):
        make_fused_render(prog, (10, 10), (4, 4), kernel="pallas", static_obj_hw=((1, 1),))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        fused_multi_ratio_render(bundle, _layout_for(bundle), ["1:1"])  # device="cuda"
