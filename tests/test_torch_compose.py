"""ops/compose of the port against the JAX package and PIL.

Both packages compose integer-exactly, so the tolerance is 0
(``np.array_equal``). Placements mirror tests/test_golden_bundles.py.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from image_transformation_tpu.core.bundle import load_bundle as jax_load_bundle
from image_transformation_tpu.layout.canvas import compute_canvas_size
from image_transformation_tpu.ops import compose as jax_compose
from image_transformation_tpu.ops.resize import build_coeffs_host
from image_transformation_tpu_torch.core.bundle import bundle_arrays_from_numpy
from image_transformation_tpu_torch.ops import compose as port_compose

BUNDLES = ["squarespace", "audio_book"]
EDGE = np.array([0, 1, 2, 64, 127, 128, 129, 200, 254, 255], np.uint8)


def test_alpha_over_all_alpha_pairs_matches_jax_and_pil():
    """Every (source alpha, destination alpha) pair, with edge and random
    colors: port == JAX == Pillow's alpha_composite."""
    rng = np.random.default_rng(0)
    sa, da = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    src = rng.integers(0, 256, (256, 256, 4), dtype=np.uint8)
    dst = rng.integers(0, 256, (256, 256, 4), dtype=np.uint8)
    src[..., 3], dst[..., 3] = sa, da
    src[:10, :, :3] = EDGE[:, None, None]  # edge colors on a band of rows
    dst[:, :10, :3] = EDGE[None, :, None]
    got = port_compose.alpha_over_u8(torch.from_numpy(dst), torch.from_numpy(src)).numpy()
    ref = np.asarray(jax_compose.alpha_over_u8(jnp.asarray(dst), jnp.asarray(src)))
    assert np.array_equal(got, ref)
    pil = Image.fromarray(dst, "RGBA")
    pil.alpha_composite(Image.fromarray(src, "RGBA"))
    assert np.array_equal(got.astype(np.uint8), np.asarray(pil))


def _placements_for(sizes, W, H, seed):
    """tests/test_golden_bundles.py:_placements_for on (w, h) sizes."""
    rng = np.random.default_rng(seed)
    placements = []
    for oid in sorted(sizes):
        ow, oh = sizes[oid]
        s = float(rng.uniform(0.25, 1.5))
        w, h = max(1, int(ow * s)), max(1, int(oh * s))
        w, h = min(w, W), min(h, H)
        x1 = int(rng.integers(0, max(1, W - w)))
        y1 = int(rng.integers(0, max(1, H - h)))
        placements.append({"object_id": oid, "box": [x1, y1, x1 + w, y1 + h]})
    oid0 = sorted(sizes)[0]
    ow, oh = sizes[oid0]
    placements.append({"object_id": oid0, "box": [0, 0, min(ow, W), min(oh, H)]})
    return placements


def _indexed_args(arrays, placements, out_max):
    pad_h, pad_w = arrays.objects.shape[1:3]
    n = len(placements)
    perm = np.zeros((n,), np.int32)
    boxes = np.zeros((n, 4), np.int32)
    kh = np.zeros((n, out_max[1], pad_w), np.int32)
    kv = np.zeros((n, out_max[0], pad_h), np.int32)
    same = np.zeros((n,), bool)
    for k, p in enumerate(placements):
        idx = arrays.index_of(p["object_id"])
        x1, y1, x2, y2 = p["box"]
        w, h = max(1, x2 - x1), max(1, y2 - y1)
        oh, ow = (int(v) for v in arrays.obj_hw[idx])
        perm[k], boxes[k] = idx, p["box"]
        kh[k] = build_coeffs_host(ow, w, pad_w, out_max[1])
        kv[k] = build_coeffs_host(oh, h, pad_h, out_max[0])
        same[k] = (w, h) == (ow, oh)
    return perm, boxes, kh, kv, same


def _both_indexed(arrays, canvas, placements):
    pad = arrays.objects.shape[1:3]
    out_max = (
        max([pad[0]] + [p["box"][3] - p["box"][1] for p in placements]),
        max([pad[1]] + [p["box"][2] - p["box"][0] for p in placements]),
    )
    args = _indexed_args(arrays, placements, out_max)
    got = port_compose.composite_canvas_tables_indexed(
        torch.from_numpy(canvas), torch.from_numpy(arrays.objects),
        *(torch.from_numpy(a) for a in args),
    ).numpy()
    ref = np.asarray(
        jax_compose.composite_canvas_tables_indexed(
            jnp.asarray(canvas), jnp.asarray(arrays.objects),
            *(jnp.asarray(a) for a in args),
        )
    )
    return got, ref


def _pil_oracle(bundle, canvas, placements):
    img = Image.fromarray(canvas, "RGBA")
    for p in placements:
        x1, y1, x2, y2 = p["box"]
        w, h = max(1, x2 - x1), max(1, y2 - y1)
        img.alpha_composite(
            bundle.objects[p["object_id"]].resize((w, h), Image.LANCZOS), dest=(x1, y1)
        )
    return np.asarray(img)


def _bundle(name):
    bundle = jax_load_bundle(f"data/{name}")
    a = bundle.to_arrays()
    return bundle, bundle_arrays_from_numpy(a.objects, a.obj_hw, a.object_ids)


@pytest.mark.parametrize("bundle_name", BUNDLES)
def test_tables_indexed_matches_jax_and_pil_at_9x16(bundle_name):
    bundle, arrays = _bundle(bundle_name)
    W, H = compute_canvas_size(bundle.background.size, "9:16", verbose=False)
    canvas = np.zeros((H, W, 4), np.uint8)
    canvas[...] = (120, 130, 140, 255)
    placements = _placements_for(bundle.sizes(), W, H, seed=len(bundle_name) * 37 + 4)
    got, ref = _both_indexed(arrays, canvas, placements)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, _pil_oracle(bundle, canvas, placements))


def test_tables_indexed_matches_jax_at_1080p():
    bundle, arrays = _bundle("squarespace")
    canvas = np.zeros((1080, 1920, 4), np.uint8)
    canvas[...] = (240, 240, 240, 255)
    placements = _placements_for(bundle.sizes(), 1920, 1080, seed=11)
    got, ref = _both_indexed(arrays, canvas, placements)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, _pil_oracle(bundle, canvas, placements))


@pytest.mark.parametrize("bundle_name", BUNDLES)
def test_negative_origin_dropped_and_overflow_clipped(bundle_name):
    bundle, arrays = _bundle(bundle_name)
    H, W = 200, 320
    canvas = np.zeros((H, W, 4), np.uint8)
    canvas[...] = (30, 60, 90, 255)
    oids = sorted(bundle.sizes())
    ow, oh = bundle.sizes()[oids[0]]
    placements = [
        # hangs off the right and bottom edges: clipped to the canvas
        {"object_id": oids[0], "box": [W - ow // 3, H - oh // 2, W - ow // 3 + ow, H - oh // 2 + oh]},
        # negative origin: dropped
        {"object_id": oids[1], "box": [-10, 20, 90, 80]},
        {"object_id": oids[-1], "box": [40, -3, 120, 40]},
    ]
    got, ref = _both_indexed(arrays, canvas, placements)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, _pil_oracle(bundle, canvas, placements[:1]))
    idx = [arrays.index_of(p["object_id"]) for p in placements]
    exact = port_compose.composite_exact(
        torch.from_numpy(canvas), torch.from_numpy(arrays.objects[idx]),
        arrays.obj_hw[idx], [p["box"] for p in placements],
    ).numpy()
    assert np.array_equal(exact, got)


def test_composite_exact_matches_jax_including_upscale():
    bundle, arrays = _bundle("audio_book")
    canvas = np.zeros((300, 500, 4), np.uint8)
    canvas[...] = (10, 200, 30, 255)
    boxes = [[5, 7, 300, 180], [100, 50, 200, 290], [250, 100, 480, 190]]
    got = port_compose.composite_exact(
        torch.from_numpy(canvas), torch.from_numpy(arrays.objects), arrays.obj_hw, boxes
    ).numpy()
    ref = np.asarray(jax_compose.composite_exact(canvas, arrays.objects, arrays.obj_hw, boxes))
    assert np.array_equal(got, ref)
    assert not np.array_equal(got, canvas)


def test_paste_object_leaves_input_canvas_untouched():
    rng = np.random.default_rng(9)
    canvas = rng.integers(0, 256, (40, 50, 4), dtype=np.uint8)
    obj = rng.integers(0, 256, (12, 20, 4)).astype(np.float32)
    t = torch.from_numpy(canvas.copy())
    got = port_compose.paste_object(t, torch.from_numpy(obj), (41, 33)).numpy()
    assert np.array_equal(t.numpy(), canvas)
    ref = np.asarray(jax_compose.paste_object(jnp.asarray(canvas), jnp.asarray(obj), (41, 33)))
    assert np.array_equal(got, ref)
