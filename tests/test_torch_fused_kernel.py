"""K1 (ops/compose_kernels) against the JAX gen-2 fused kernel and PIL.

The plain version runs here on the CPU; the JAX side is the gen-2 Pallas
kernel fed host tables, in interpret mode on the CPU backend, as the JAX
package's own tests run it. Both are integer-exact, so the tolerance is 0
(``np.array_equal``). The card test compares the CUDA kernel with its
plain version and skips without a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from image_transformation_tpu.core.bundle import load_bundle as jax_load_bundle
from image_transformation_tpu.ops.compose_pallas import (
    composite_batch_fused_v2_host_tables,
)
from image_transformation_tpu_torch.core.bundle import bundle_arrays_from_numpy
from image_transformation_tpu_torch.ops import compose_kernels
from image_transformation_tpu_torch.ops.compose_kernels import (
    FLAG_IDENTITY,
    FLAG_LIVE,
    fused_compose,
    fused_compose_reference,
    fused_tables_prep,
)
from image_transformation_tpu_torch.parallel.sweep import random_downscale_boxes

BUNDLES = ["squarespace", "audio_book"]
H, W, B = 240, 400, 2


def _arrays(bundle_name):
    a = jax_load_bundle(f"data/{bundle_name}").to_arrays()
    return bundle_arrays_from_numpy(a.objects, a.obj_hw, a.object_ids)


def _batch(arrays, boxes, canvas_value=(90, 110, 130, 255)):
    canvases = np.empty((B, H, W, 4), np.uint8)
    canvases[...] = canvas_value
    objs = np.broadcast_to(arrays.objects, (B, *arrays.objects.shape)).copy()
    hw = np.broadcast_to(arrays.obj_hw, (B, *arrays.obj_hw.shape)).copy()
    return canvases, objs, hw, boxes


def _jax_fused(canvases, objs, hw, boxes):
    return np.asarray(
        composite_batch_fused_v2_host_tables(
            jnp.asarray(canvases), jnp.asarray(objs), hw, boxes, interpret=True
        )
    )


def _port(canvases, objs, hw, boxes, device="cpu", fn=fused_compose):
    pad = objs.shape[2:4]
    kh, kv, boxes_i32, flags = fused_tables_prep(hw, boxes, (H, W), pad, pad)
    # np.array copies: the wrapper composes into the canvas in place
    t = [torch.from_numpy(np.array(a)).to(device)
         for a in (canvases, objs, kh, kv, boxes_i32, flags)]
    return fn(*t).cpu().numpy()


def _random_boxes(arrays, seed):
    rng = np.random.default_rng(seed)
    return np.stack(
        [random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(B)]
    )


@pytest.mark.parametrize("bundle_name", BUNDLES)
def test_plain_version_matches_jax_fused_v2(bundle_name):
    arrays = _arrays(bundle_name)
    boxes = _random_boxes(arrays, 41)
    oh0, ow0 = (int(v) for v in arrays.obj_hw[0])
    # object 0 of canvas 1 hangs off the right and bottom edges (clipped)
    boxes[1, 0] = [W - ow0 // 2, H - 5, W + ow0 // 2, H - 5 + oh0]
    args = _batch(arrays, boxes)
    got = _port(*args)
    assert np.array_equal(got, _jax_fused(*args))
    assert not np.array_equal(got, args[0])  # something was composed


def test_all_identity_batch_matches_jax():
    arrays = _arrays("squarespace")
    n = arrays.obj_hw.shape[0]
    boxes = np.zeros((B, n, 4), np.int32)
    for b in range(B):
        for k in range(n):
            oh, ow = (int(v) for v in arrays.obj_hw[k])
            x1, y1 = 7 * k + 3 * b, 5 * k + b
            boxes[b, k] = [x1, y1, x1 + ow, y1 + oh]
    pad = arrays.objects.shape[1:3]
    _, _, _, flags = fused_tables_prep(
        np.broadcast_to(arrays.obj_hw, (B, n, 2)), boxes, (H, W), pad, pad
    )
    assert (flags == FLAG_LIVE | FLAG_IDENTITY).all()
    args = _batch(arrays, boxes)
    assert np.array_equal(_port(*args), _jax_fused(*args))


def test_shared_objects_match_per_canvas_copies():
    arrays = _arrays("audio_book")
    boxes = _random_boxes(arrays, 7)
    canvases, objs, hw, _ = _batch(arrays, boxes)
    pad = objs.shape[2:4]
    kh, kv, boxes_i32, flags = fused_tables_prep(hw, boxes, (H, W), pad, pad)
    tables = [torch.from_numpy(a) for a in (kh, kv, boxes_i32, flags)]
    shared = fused_compose(
        torch.from_numpy(canvases.copy()), torch.from_numpy(objs[:1].copy()), *tables
    )
    copies = fused_compose(
        torch.from_numpy(canvases.copy()), torch.from_numpy(objs), *tables
    )
    assert torch.equal(shared, copies)


def test_dropped_origin_matches_jax():
    arrays = _arrays("squarespace")
    boxes = _random_boxes(arrays, 3)
    boxes[0, 1] = [-4, 10, 60, 50]     # negative x origin: dropped
    boxes[1, 2] = [20, -1, 80, 40]     # negative y origin: dropped
    boxes[1, 3] = [W, 10, W + 30, 20]  # origin off the canvas: dropped
    pad = arrays.objects.shape[1:3]
    hw = np.broadcast_to(arrays.obj_hw, (B, *arrays.obj_hw.shape))
    _, _, _, flags = fused_tables_prep(hw, boxes, (H, W), pad, pad)
    assert flags[0, 1] == flags[1, 2] == flags[1, 3] == 0
    args = _batch(arrays, boxes)
    got = _port(*args)
    assert np.array_equal(got, _jax_fused(*args))
    # dropping them equals composing without them
    keep = np.ones(boxes.shape[:2], bool)
    keep[0, 1] = keep[1, 2] = keep[1, 3] = False
    for b in range(B):
        canvas = torch.from_numpy(args[0][b].copy())
        k_live = np.nonzero(keep[b])[0]
        kh, kv, bx, fl = fused_tables_prep(
            hw[b:b + 1, k_live], boxes[b:b + 1, k_live], (H, W), pad, pad
        )
        alone = fused_compose(
            canvas[None].contiguous(),
            torch.from_numpy(arrays.objects[k_live])[None].contiguous(),
            *(torch.from_numpy(a) for a in (kh, kv, bx, fl)),
        )
        assert np.array_equal(got[b], alone[0].numpy())


def test_wrapper_rejects_bad_arguments():
    arrays = _arrays("audio_book")
    canvases, objs, hw, boxes = _batch(arrays, _random_boxes(arrays, 1))
    pad = objs.shape[2:4]
    kh, kv, bx, fl = fused_tables_prep(hw, boxes, (H, W), pad, pad)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (canvases, objs, kh, kv, bx, fl)]
    with pytest.raises(TypeError):
        fused_compose(t[0], t[1], t[2].to(torch.int64), *t[3:])
    with pytest.raises(ValueError):
        fused_compose(t[0], t[1][:, :, :-1].contiguous(), *t[2:])
    with pytest.raises(ValueError):
        fused_compose(t[0].transpose(1, 2), *t[1:])


def test_cpu_path_counts_no_launch():
    arrays = _arrays("audio_book")
    compose_kernels.reset_launch_counts()
    _port(*_batch(arrays, _random_boxes(arrays, 2)))
    assert compose_kernels.LAUNCHES["fused_compose"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("bundle_name", BUNDLES)
def test_cuda_kernel_matches_plain_version(bundle_name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    arrays = _arrays(bundle_name)
    boxes = _random_boxes(arrays, 5)
    oh0, ow0 = (int(v) for v in arrays.obj_hw[0])
    boxes[0, 0] = [W - ow0, H - oh0, W, H]  # identity at the corner
    boxes[1, 0] = [W - ow0 // 2, H - 5, W + ow0 // 2, H - 5 + oh0]
    boxes[1, 1] = [-3, 4, 50, 40]  # dropped
    args = _batch(arrays, boxes)
    before = compose_kernels.LAUNCHES["fused_compose"]
    got = _port(*args, device="cuda")
    torch.cuda.synchronize()
    assert compose_kernels.LAUNCHES["fused_compose"] == before + 1
    plain = _port(*args, device="cuda", fn=fused_compose_reference)
    assert np.array_equal(got, plain)
    assert np.array_equal(got, _port(*args))


def _fuzz_case(seed):
    """Random objects (random alpha), pad envelope, canvas and boxes that
    may upscale, hang off the edges, fall off the canvas or be identity."""
    rng = np.random.default_rng(seed)
    b, n = int(rng.integers(1, 4)), int(rng.integers(1, 6))
    ph, pw = (int(v) for v in rng.integers(3, 70, 2))
    h, w = (int(v) for v in rng.integers(8, 120, 2))
    mh, mw = ph + int(rng.integers(0, 20)), pw + int(rng.integers(0, 20))
    objs = rng.integers(0, 256, (b, n, ph, pw, 4), dtype=np.uint8)
    hw = np.stack([rng.integers(1, ph + 1, (b, n)), rng.integers(1, pw + 1, (b, n))], -1)
    for bi in range(b):
        for k in range(n):
            objs[bi, k, hw[bi, k, 0]:] = 0
            objs[bi, k, :, hw[bi, k, 1]:] = 0
    boxes = np.zeros((b, n, 4), np.int64)
    for bi in range(b):
        for k in range(n):
            oh, ow = hw[bi, k]
            bh, bw = ((oh, ow) if rng.random() < 0.25 else
                      (int(rng.integers(1, mh + 1)), int(rng.integers(1, mw + 1))))
            x1, y1 = int(rng.integers(-3, w + 2)), int(rng.integers(-3, h + 2))
            boxes[bi, k] = (x1, y1, x1 + bw, y1 + bh)
    canvases = rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8)
    canvases[..., 3] = rng.choice([0, 90, 255], (b, h, w))
    kh, kv, bx, fl = fused_tables_prep(hw, boxes, (h, w), (ph, pw), (mh, mw))
    return canvases, objs, hw, boxes, (kh, kv, bx, fl), (mh, mw)


@pytest.mark.parametrize("seed", range(4))
def test_plain_version_fuzz_matches_jax_fused_v2(seed):
    canvases, objs, hw, boxes, tables, out_max = _fuzz_case(seed)
    ref = np.asarray(
        composite_batch_fused_v2_host_tables(
            jnp.asarray(canvases), jnp.asarray(objs), hw, boxes,
            out_max_hw=out_max, interpret=True,
        )
    )
    got = fused_compose(
        torch.from_numpy(canvases.copy()), torch.from_numpy(objs),
        *(torch.from_numpy(a) for a in tables),
    ).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.cuda
def test_cuda_kernel_fuzz_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    for seed in range(40):
        canvases, objs, _, _, tables, _ = _fuzz_case(seed)
        for shared in (False, True):
            o = objs[:1] if shared else objs
            plain = fused_compose(
                torch.from_numpy(canvases.copy()), torch.from_numpy(np.array(o)),
                *(torch.from_numpy(a) for a in tables),
            ).numpy()
            got = fused_compose(
                torch.from_numpy(canvases.copy()).cuda(),
                torch.from_numpy(np.array(o)).cuda(),
                *(torch.from_numpy(a).cuda() for a in tables),
            ).cpu().numpy()
            assert np.array_equal(got, plain), (seed, shared)


def _window_case(seed):
    """Random objects on pads up to 300x400 (so the resample core walks its
    source patch in chunks of rows and columns), with 1-px boxes (a window
    spanning the whole source row), boxes equal to the object (identity),
    upscales, dropped origins, boxes hanging off the canvas edge, and every
    placement of canvas 0 at one origin (overlaps, for z-order)."""
    rng = np.random.default_rng(1000 + seed)
    b, n = int(rng.integers(1, 4)), int(rng.integers(2, 6))
    ph, pw = int(rng.integers(40, 300)), int(rng.integers(60, 400))
    h, w = int(rng.integers(40, 260)), int(rng.integers(40, 420))
    mh, mw = ph + int(rng.integers(0, 40)), pw + int(rng.integers(0, 40))
    objs = rng.integers(0, 256, (b, n, ph, pw, 4), dtype=np.uint8)
    hw = np.stack([rng.integers(1, ph + 1, (b, n)), rng.integers(1, pw + 1, (b, n))], -1)
    for bi in range(b):
        for k in range(n):
            objs[bi, k, hw[bi, k, 0]:] = 0
            objs[bi, k, :, hw[bi, k, 1]:] = 0
    boxes = np.zeros((b, n, 4), np.int64)
    for bi in range(b):
        for k in range(n):
            oh, ow = (int(v) for v in hw[bi, k])
            mode = int(rng.integers(0, 5))
            bh, bw = {0: (oh, ow), 1: (1, 1), 2: (int(rng.integers(1, mh + 1)),
                                                  int(rng.integers(1, mw + 1)))}.get(
                mode, (max(1, int(oh * rng.uniform(0.05, 1))), max(1, int(ow * rng.uniform(0.05, 1)))))
            x1, y1 = int(rng.integers(-3, w + 2)), int(rng.integers(-3, h + 2))
            if bi == 0:
                x1, y1 = 2, 3
            boxes[bi, k] = (x1, y1, x1 + bw, y1 + bh)
    canvases = rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8)
    canvases[..., 3] = rng.choice([0, 90, 255], (b, h, w))
    tables = fused_tables_prep(hw, boxes, (h, w), (ph, pw), (mh, mw))
    return canvases, objs, hw, boxes, tables


@pytest.mark.cuda
def test_cuda_kernel_tap_windows_match_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    for seed in range(12):
        canvases, objs, _, _, tables = _window_case(seed)
        plain = fused_compose(
            torch.from_numpy(canvases.copy()), torch.from_numpy(objs),
            *(torch.from_numpy(a) for a in tables),
        ).numpy()
        before = compose_kernels.LAUNCHES["fused_compose"]
        got = fused_compose(
            torch.from_numpy(canvases.copy()).cuda(), torch.from_numpy(objs).cuda(),
            *(torch.from_numpy(a).cuda() for a in tables),
        ).cpu().numpy()
        assert compose_kernels.LAUNCHES["fused_compose"] == before + 1
        assert np.array_equal(got, plain), seed


@pytest.mark.cuda
def test_cuda_bounds_launch_equals_the_tables_nonzeros():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1's bounds launch has no CPU mode")
    for seed in range(6):
        canvases, _, _, _, tables = _window_case(seed)
        t = [torch.from_numpy(a) for a in tables]
        # some random sparse tables too: windows the kernel must find exactly
        rng = np.random.default_rng(seed)
        t[0] = t[0] * torch.from_numpy(rng.random(t[0].shape) < 0.7).to(torch.int32)
        hw_ref, vw_ref, ext_ref = compose_kernels.k1_tap_windows_reference(
            *t, canvases.shape[1:3])
        hw_k, vw_k, ext_k = (x.cpu() for x in compose_kernels.k1_tap_windows(
            *(x.cuda() for x in t), canvases.shape[1:3]))
        assert torch.equal(ext_k, ext_ref), seed
        resampled = ((t[3] & FLAG_LIVE) > 0) & ((t[3] & FLAG_IDENTITY) == 0)
        assert torch.equal(hw_k[resampled], hw_ref[resampled]), seed
        assert torch.equal(vw_k[resampled], vw_ref[resampled]), seed


@pytest.mark.cuda
def test_cuda_traced_and_upscaling_tables_through_composite_batch_pallas():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    from image_transformation_tpu_torch.ops.resize import build_coeffs_traced

    for seed in range(4):
        rng = np.random.default_rng(500 + seed)
        b, n, ph, pw = 2, 3, int(rng.integers(8, 90)), int(rng.integers(8, 140))
        mh, mw = 3 * ph, 3 * pw  # the envelope admits upscales
        h, w = 2 * mh, 2 * mw
        objs = rng.integers(0, 256, (b, n, ph, pw, 4), dtype=np.uint8)
        hw = np.broadcast_to(np.array([ph, pw]), (b, n, 2)).copy()
        out_h = rng.integers(1, mh + 1, (b, n))
        out_w = rng.integers(1, mw + 1, (b, n))
        xy = np.stack([rng.integers(-2, w, (b, n)), rng.integers(-2, h, (b, n))], -1)
        boxes = np.concatenate([xy, xy + np.stack([out_w, out_h], -1)], -1)
        kh = build_coeffs_traced(torch.from_numpy(hw[..., 1]), torch.from_numpy(out_w), pw, mw)
        kv = build_coeffs_traced(torch.from_numpy(hw[..., 0]), torch.from_numpy(out_h), ph, mh)
        canvases = torch.from_numpy(rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8))
        args = (torch.from_numpy(objs), hw, boxes, kh, kv)
        plain = compose_kernels.composite_batch_pallas(canvases, *args)
        got = compose_kernels.composite_batch_pallas(
            canvases.cuda(), args[0].cuda(), hw, boxes, kh.cuda(), kv.cuda())
        assert torch.equal(got.cpu(), plain), seed


@pytest.mark.cuda
def test_cuda_kernel_runs_past_65535_placements():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    rng = np.random.default_rng(3)
    n, pattern, b = 4, 7, 16_500  # B*N = 66,000: past CUDA's gridDim.y/z limit
    h, w, ph, pw = 12, 16, 5, 6
    objs = rng.integers(0, 256, (1, n, ph, pw, 4), dtype=np.uint8)
    hw = np.broadcast_to(np.array([ph, pw]), (b, n, 2))
    base = rng.integers(-1, 10, (pattern, n, 2))
    size = rng.integers(1, 9, (pattern, n, 2))
    boxes_p = np.concatenate([base, base + size], -1)
    boxes = boxes_p[np.arange(b) % pattern]
    canvas = np.broadcast_to(rng.integers(0, 256, (h, w, 4), dtype=np.uint8), (b, h, w, 4))
    tables = fused_tables_prep(hw, boxes, (h, w), (ph, pw), (ph + 2, pw + 2))
    got = fused_compose(
        torch.from_numpy(canvas.copy()).cuda(), torch.from_numpy(objs).cuda(),
        *(torch.from_numpy(a).cuda() for a in tables),
    ).cpu().numpy()
    plain = fused_compose(
        torch.from_numpy(canvas[:pattern].copy()), torch.from_numpy(objs),
        *(torch.from_numpy(a[:pattern].copy()) for a in tables),
    ).numpy()
    assert np.array_equal(got, plain[np.arange(b) % pattern])


@pytest.mark.cuda
def test_cuda_dense_arbitrary_tables_match_plain_version():
    """Tables no Pillow window gives: random dense rows (more taps than a
    tile's compact arrays hold, so the kernel reads them from the rows) and
    random empty rows (extents short of the envelope)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    for seed in range(4):
        rng = np.random.default_rng(900 + seed)
        b, n, ph, pw, mh, mw = 2, 3, 40 + 10 * seed, 90, 70, 60
        objs = rng.integers(0, 256, (b, n, ph, pw, 4), dtype=np.uint8)
        # |w| <= 2^16 over <= 90 taps keeps every int32 sum exact
        kh = rng.integers(-(1 << 14), 1 << 16, (b, n, mw, pw)).astype(np.int32)
        kv = rng.integers(-(1 << 14), 1 << 16, (b, n, mh, ph)).astype(np.int32)
        kh[rng.random((b, n, mw)) < 0.3] = 0
        kv[rng.random((b, n, mh)) < 0.3] = 0
        boxes = np.stack([rng.integers(-2, 100, (b, n)), rng.integers(-2, 80, (b, n))], -1)
        boxes = np.concatenate([boxes, boxes + 5], -1).astype(np.int32)
        flags = np.where(rng.random((b, n)) < 0.8, FLAG_LIVE, 0).astype(np.uint8)
        canvases = rng.integers(0, 256, (b, 90, 120, 4), dtype=np.uint8)
        args = [canvases, objs, kh, kv, boxes, flags]
        plain = fused_compose(*(torch.from_numpy(a.copy()) for a in args)).numpy()
        got = fused_compose(*(torch.from_numpy(a.copy()).cuda() for a in args)).cpu().numpy()
        assert np.array_equal(got, plain), seed


@pytest.mark.cuda
def test_cuda_pads_past_the_staged_taps_match_plain_version():
    """Objects padded to 3999x3601: the tiles' compact tap arrays do not fit
    beside the resample core, so every tile reads its taps from the table
    rows. A 1-px box (one window spanning the whole source, which stages the
    objects tensor's last pixels: its pixel count is odd), a steep downscale
    overlapping it, and an identity copy of a small object in the pad."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    rng = np.random.default_rng(12)
    n, ph, pw, mh, mw, h, w = 3, 3999, 3601, 64, 64, 80, 120
    objs = rng.integers(0, 256, (1, n, ph, pw, 4), dtype=np.uint8)
    objs[0, 2, 40:] = 0
    objs[0, 2, :, 50:] = 0
    hw = np.array([[[ph, pw], [ph - 1, pw - 80], [40, 50]]])
    boxes = np.array([[[3, 2, 4, 3], [0, 0, 50, 60], [9, 7, 59, 47]]])
    canvas = rng.integers(0, 256, (1, h, w, 4), dtype=np.uint8)
    tables = fused_tables_prep(hw, boxes, (h, w), (ph, pw), (mh, mw))
    assert tables[3].tolist() == [[FLAG_LIVE, FLAG_LIVE, FLAG_LIVE | FLAG_IDENTITY]]
    plain = fused_compose(torch.from_numpy(canvas.copy()), torch.from_numpy(objs),
                          *(torch.from_numpy(a) for a in tables)).numpy()
    before = compose_kernels.LAUNCHES["fused_compose"]
    got = fused_compose(torch.from_numpy(canvas.copy()).cuda(), torch.from_numpy(objs).cuda(),
                        *(torch.from_numpy(a).cuda() for a in tables)).cpu().numpy()
    assert compose_kernels.LAUNCHES["fused_compose"] == before + 1
    assert not np.array_equal(got, canvas)
    assert np.array_equal(got, plain)
