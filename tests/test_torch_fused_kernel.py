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
