"""The public compose functions the port adds to ``image_transformation_tpu_torch.ops``
(``composite_batch_hybrid``, ``composite_batch_aligned``,
``composite_batch_hybrid_packed``'s ``rowbaked`` / ``band`` / ``batchsrc`` /
``resident`` flags, ``composite_batch_pallas(_host_tables)`` and
``composite_canvas_tables``) against the JAX package (interpret mode) on the
CPU, on both bundles.

Tolerances: the traced-table paths are within 1 (of 255) on at most 1e-3 of
the pixels of JAX under the exact-resample pin (the f32 tables may differ
by 1 unit, tests/test_torch_hybrid.py) and equal the port's
``ops.compose.composite_batch`` at the rounded envelope (0); the host-table
paths equal JAX, the port's ``composite_exact`` and PIL (0).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from image_transformation_tpu.ops import compose as jcompose
from image_transformation_tpu.ops import compose_pallas as jcp
from image_transformation_tpu_torch import ops
from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.ops.compose import composite_batch, composite_exact
from image_transformation_tpu_torch.ops.resize import build_coeffs_traced
from tests.test_torch_hybrid import (  # noqa: F401  (the fixture is used by name)
    _assert_within_one,
    _batch,
    _edge_boxes,
    exact_traced_resample,
)

BUNDLES = ["squarespace", "audio_book"]
#: (port function, JAX function, keyword flags) of each traced-table path
PATHS = {
    "hybrid": (ops.composite_batch_hybrid, jcp.composite_batch_hybrid, {}),
    "aligned": (ops.composite_batch_aligned, jcp.composite_batch_aligned, {}),
    "rowbaked": (ck.composite_batch_hybrid_packed, jcp.composite_batch_hybrid_packed,
                 {"rowbaked": True}),
    "band": (ck.composite_batch_hybrid_packed, jcp.composite_batch_hybrid_packed,
             {"band": True}),
    "batchsrc": (ck.composite_batch_hybrid_packed, jcp.composite_batch_hybrid_packed,
                 {"batchsrc": True}),
    "resident": (ck.composite_batch_hybrid_packed, jcp.composite_batch_hybrid_packed,
                 {"resident": True}),
}


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _run(path, canvases, objs, hw, boxes, **kw):
    """(port output, JAX interpret output, the port's composite_batch)."""
    port_fn, jax_fn, flags = PATHS[path]
    ct, ot = torch.from_numpy(canvases), torch.from_numpy(objs)
    out = port_fn(ct, ot, hw, boxes, **flags, **kw)
    ref = np.asarray(jax_fn(*_j(canvases, objs, hw, boxes), interpret=True, **flags, **kw))
    env = ck._blend_envelope(ot, kw.get("out_max_hw"))
    return out.numpy(), ref, composite_batch(ct, ot, hw, boxes, env).numpy()


def _pil(bundle_name, canvas, boxes):
    """PIL's own compose of one canvas: LANCZOS resize + alpha_composite in
    list order, placements whose origin is off the canvas dropped."""
    bundle = load_bundle(f"data/{bundle_name}")
    img = Image.fromarray(canvas)
    H, W = canvas.shape[:2]
    for oid, (x1, y1, x2, y2) in zip(bundle.object_ids(), boxes.tolist()):
        if 0 <= x1 < W and 0 <= y1 < H:
            obj = bundle.objects[oid].resize((max(1, x2 - x1), max(1, y2 - y1)), Image.LANCZOS)
            img.alpha_composite(obj, dest=(x1, y1))
    return np.asarray(img)


def _small_batch(bundle_name, seed):
    canvases, objs, hw, boxes = _batch(bundle_name, 2, 300, 400, seed)
    oh0, ow0 = (int(v) for v in hw[0, 0])
    boxes[0, 0] = [3, 5, 3 + ow0, 5 + oh0]  # identity size
    boxes[1, 0] = [-7, -7, -7 + ow0, -7 + oh0]  # dropped
    return canvases, objs, hw, boxes


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("bundle_name", BUNDLES)
def test_public_path_matches_jax_and_composite_batch(bundle_name, path, exact_traced_resample):
    out, ref, plain = _run(path, *_small_batch(bundle_name, 11))
    assert out.shape == ref.shape and out.dtype == np.uint8
    _assert_within_one(out, ref)
    assert np.array_equal(out, plain)


@pytest.mark.parametrize("path", ["rowbaked", "aligned"])
def test_shifted_paths_edge_boxes_1080p(path, exact_traced_resample):
    """Edge-flush, hanging, 1 px and dropped boxes at 1080x1920: the capped
    origins of the row-baked path give dx >= 128; the aligned path's sources
    are whole windows on the legacy plane."""
    H, W = 1080, 1920
    canvases, objs, hw, boxes = _batch("squarespace", 3, H, W, 13)
    boxes = _edge_boxes(boxes, hw, H, W)
    out, ref, plain = _run(path, canvases, objs, hw, boxes)
    _assert_within_one(out, ref)
    assert np.array_equal(out, plain)
    oh0, ow0 = (int(v) for v in hw[0, 0])  # object 0 lies flush in the corner
    assert (out[0, H - oh0:, W - ow0:] != canvases[0, H - oh0:, W - ow0:]).any()
    if path == "rowbaked":
        meta = ck._hybrid_producer_rowbaked(torch.from_numpy(canvases), torch.from_numpy(objs),
                                            hw, boxes, (208, 384), "lanczos")[2]
        assert int(meta[..., 2].max()) >= 128


def test_aligned_identity_copy_clamps_as_jax(exact_traced_resample):
    """JAX places the aligned path's identity copy with dynamic_update_slice,
    which clamps its start: with an envelope below the object pad plus the
    origin slack, an identity object is moved up. The port does the same
    (a fault of the reference, ROADMAP C), and raises where the copy does
    not fit at all, as JAX does."""
    canvases, objs, hw, boxes = _batch("squarespace", 1, 300, 400, 3)
    oh0, ow0 = (int(v) for v in hw[0, 0])
    boxes[0, 0] = [3, 5, 3 + ow0, 5 + oh0]  # identity size, dy = 5
    boxes[0, 1:, :2] = -1  # the others dropped: the raw copy alone is compared
    out, ref, plain = _run("aligned", canvases, objs, hw, boxes, out_max_hw=(200, 300))
    assert np.array_equal(out, ref)
    rows = [np.flatnonzero((x[0] != canvases[0]).any(axis=(1, 2))) for x in (out, plain)]
    assert rows[0][0] == rows[1][0] - 4  # moved up: MH = 208 leaves room for dy = 1 only
    ct, ot = torch.from_numpy(canvases), torch.from_numpy(objs)
    with pytest.raises(ValueError, match="window"):
        ops.composite_batch_aligned(ct, ot, hw, boxes, out_max_hw=(100, 100))
    with pytest.raises(TypeError):
        jcp.composite_batch_aligned(*_j(canvases, objs, hw, boxes), out_max_hw=(100, 100),
                                    interpret=True)


@pytest.mark.parametrize("bundle_name", BUNDLES)
def test_pallas_host_tables_equal_jax_composite_exact_and_pil(bundle_name):
    canvases, objs, hw, boxes = _small_batch(bundle_name, 7)
    ck.reset_launch_counts()
    out = ops.composite_batch_pallas_host_tables(torch.from_numpy(canvases),
                                                 torch.from_numpy(objs), hw, boxes)
    assert ck.LAUNCHES["fused_compose"] == 0  # the CPU runs K1's plain version
    ref = np.asarray(jcp.composite_batch_pallas_host_tables(canvases, objs, hw, boxes,
                                                            interpret=True))
    assert np.array_equal(out.numpy(), ref)
    for b in range(2):
        exact = composite_exact(torch.from_numpy(canvases[b]), torch.from_numpy(objs[b]),
                                hw[b], boxes[b], objs.shape[2:4])
        assert np.array_equal(out[b].numpy(), exact.numpy())
        assert np.array_equal(out[b].numpy(), _pil(bundle_name, canvases[b], boxes[b]))


def test_pallas_with_traced_tables_equals_jax():
    """composite_batch_pallas takes any int32 tables; given the same traced
    tables, JAX's gen-1 kernel and K1's plain version agree byte for byte."""
    canvases, objs, hw, boxes = _small_batch("audio_book", 9)
    w = np.maximum(1, boxes[..., 2] - boxes[..., 0])
    h = np.maximum(1, boxes[..., 3] - boxes[..., 1])
    ph, pw = objs.shape[2:4]
    kh = build_coeffs_traced(torch.from_numpy(hw[..., 1]), torch.from_numpy(w), pw, pw).numpy()
    kv = build_coeffs_traced(torch.from_numpy(hw[..., 0]), torch.from_numpy(h), ph, ph).numpy()
    out = ops.composite_batch_pallas(torch.from_numpy(canvases), torch.from_numpy(objs),
                                     hw, boxes, kh, kv)
    ref = np.asarray(jcp.composite_batch_pallas(*_j(canvases, objs, hw, boxes, kh, kv),
                                                interpret=True))
    assert np.array_equal(out.numpy(), ref)
    assert (out.numpy() != canvases).any()


@pytest.mark.parametrize("bundle_name", BUNDLES)
def test_composite_canvas_tables_equals_jax_and_composite_exact(bundle_name):
    canvases, objs, hw, boxes = _small_batch(bundle_name, 5)
    canvas, obj, sizes, bx = canvases[0], objs[0], hw[0:1], boxes[0:1]
    kh, kv, _, flags = ck.fused_tables_prep(sizes, bx, canvas.shape[:2], obj.shape[1:3],
                                            obj.shape[1:3])
    same = (flags[0] & ck.FLAG_IDENTITY) > 0
    got = ops.composite_canvas_tables(torch.from_numpy(canvas), torch.from_numpy(obj), bx[0],
                                      kh[0], kv[0], same)
    ref = np.asarray(jcompose.composite_canvas_tables(*_j(canvas, obj, bx[0], kh[0], kv[0],
                                                          same)))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), ref)
    exact = composite_exact(torch.from_numpy(canvas), torch.from_numpy(obj), hw[0], boxes[0],
                            obj.shape[1:3])
    assert torch.equal(got, exact)


def test_public_paths_never_write_their_inputs():
    canvases, objs, hw, boxes = _small_batch("squarespace", 8)
    ct, ot = torch.from_numpy(canvases.copy()), torch.from_numpy(objs.copy())
    for path, (fn, _, flags) in PATHS.items():
        out = fn(ct, ot, hw, boxes, **flags)
        assert out.data_ptr() != ct.data_ptr() and (out.numpy() != canvases).any(), path
    ops.composite_batch_pallas_host_tables(ct, ot, hw, boxes)
    assert np.array_equal(ct.numpy(), canvases) and np.array_equal(ot.numpy(), objs)
