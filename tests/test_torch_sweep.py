"""The port's parallel/sweep.py against the JAX package's, on the CPU.

JAX's steps run on its CPU backend, where the Pallas kernels have no
Mosaic and its steps fall back to the XLA compose; the port's run the
plain versions of K2/K3. The ``exact_traced_resample`` pin makes JAX's
XLA resample the exact integer one, so the two differ only by the
traced tables' 1-unit flips: composed pixels agree within 1 (the JAX
package's cross-program bound, tests/test_parallel.py:192-196) and the
luminance stats within 1e-3 absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_transformation_tpu.core.bundle import load_bundle as jax_load_bundle
from image_transformation_tpu.ops import resize as jrz
from image_transformation_tpu.ops.compose_pallas import packed_to_u8_np
from image_transformation_tpu.parallel import sweep as jsweep
from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.parallel import (
    batched_compose_step,
    make_batched_compose,
    make_solid_render_step,
    throughput_sweep,
)
from image_transformation_tpu_torch.parallel.sweep import random_downscale_boxes


@pytest.fixture
def exact_traced_resample(monkeypatch):
    monkeypatch.setattr(jrz, "resample_fixed_traced", jrz.resample_fixed)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _batch(bundle_name, B, H, W, seed, canvas_value=128):
    arrays = jax_load_bundle(f"data/{bundle_name}").to_arrays()
    rng = np.random.default_rng(seed)
    canvases = np.zeros((B, H, W, 4), np.uint8)
    canvases[..., :3] = canvas_value
    canvases[..., 3] = 255
    objs = np.broadcast_to(arrays.objects, (B, *arrays.objects.shape)).copy()
    hw = np.broadcast_to(arrays.obj_hw, (B, *arrays.obj_hw.shape)).astype(np.int32)
    boxes = np.stack(
        [random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(B)]
    ).astype(np.int32)
    return canvases, objs, hw, boxes, arrays.objects.shape[1:3]


def _assert_within_one(got, ref):
    d = np.abs(np.asarray(got).astype(np.int64) - np.asarray(ref).astype(np.int64))
    assert d.max() <= 1
    assert (d > 0).mean() <= 1e-3


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_batched_compose_matches_jax(kernel, exact_traced_resample):
    canvases, objs, hw, boxes, pad = _batch("audio_book", 2, 200, 256, 3, 77)
    ref_out, ref_luma = jsweep.make_batched_compose(pad, kernel="xla")(
        *(jnp.asarray(x) for x in (canvases, objs, hw, boxes)))
    step = make_batched_compose(pad, kernel=kernel, device="cpu")
    out, luma = step(canvases, objs, hw, boxes)
    assert out.dtype == torch.uint8 and tuple(out.shape) == canvases.shape
    _assert_within_one(out.numpy(), ref_out)
    np.testing.assert_allclose(luma.numpy(), np.asarray(ref_luma), atol=1e-3)
    assert batched_compose_step is make_batched_compose
    with pytest.raises(ValueError):
        make_batched_compose(pad, kernel="mosaic", device="cpu")


def test_xla_step_crops_an_upscale_past_the_pad_as_jax(exact_traced_resample):
    """kernel="xla" is JAX's XLA step: a box larger than ``out_max_hw`` is
    resized to its full size and cut at the envelope. (A gen-3 step would
    clamp the target size to its window and render another scale: max abs
    diff 255 on ~45k pixels here.)"""
    canvases, objs, hw, boxes, pad = _batch("audio_book", 1, 300, 520, 3)
    assert tuple(hw[0, 0]) == (237, 186) and tuple(pad) == (237, 447)
    boxes[0, 0] = [40, 20, 40 + 226, 20 + 257]  # upscales past the pad's height
    ref_out, ref_luma = jsweep.make_batched_compose(pad, kernel="xla")(
        *(jnp.asarray(x) for x in (canvases, objs, hw, boxes)))
    out, luma = make_batched_compose(pad, kernel="xla", device="cpu")(canvases, objs, hw, boxes)
    _assert_within_one(out.numpy(), ref_out)
    np.testing.assert_allclose(luma.numpy(), np.asarray(ref_luma), atol=1e-3)


@pytest.mark.parametrize("stat", ["luma", "fence"])
def test_solid_render_step_matches_jax(stat, exact_traced_resample):
    canvases, objs, hw, boxes, pad = _batch("squarespace", 2, 200, 256, 5)
    H, W = canvases.shape[1:3]
    jstep = jsweep.make_solid_render_step((H, W), pad, stat=stat, reuse=False)
    ref_plane, ref_stat = jstep(*(jnp.asarray(x) for x in (canvases, objs, hw, boxes)))
    step = make_solid_render_step((H, W), pad, stat=stat, reuse=False, device="cpu")
    plane, st = step(None, objs, hw, boxes)
    assert tuple(plane.shape) == tuple(ref_plane.shape)
    _assert_within_one(packed_to_u8_np(plane.numpy())[:, :H, :W],
                       packed_to_u8_np(np.asarray(ref_plane))[:, :H, :W])
    if stat == "luma":
        np.testing.assert_allclose(st.numpy(), np.asarray(ref_stat), atol=1e-3)
    else:
        assert st.dtype == torch.int32
        assert np.array_equal(st.numpy(), np.asarray(ref_stat))


def test_solid_render_step_reuse_and_release():
    canvases, objs, hw, boxes, pad = _batch("squarespace", 2, 160, 240, 9)
    H, W = canvases.shape[1:3]
    rng = np.random.default_rng(1)
    arrays = load_bundle("data/squarespace").to_arrays()
    sets = [boxes] + [
        np.stack([random_downscale_boxes(rng, arrays.obj_hw, (H, W)) for _ in range(2)])
        for _ in range(3)
    ]
    static = tuple(tuple(int(v) for v in row) for row in arrays.obj_hw)
    fresh = make_solid_render_step((H, W), pad, static_obj_hw=static, reuse=False,
                                   stat="fence", device="cpu")
    step = make_solid_render_step((H, W), pad, static_obj_hw=static, stat="fence",
                                  device="cpu")
    objs_p = ck.planarize_objects(torch.from_numpy(objs[:1]))  # shared, planar
    first, _ = step(None, objs_p, hw, sets[0])
    for bx in sets[1:]:
        plane, st = step(None, objs_p, hw, bx)
        assert plane.data_ptr() == first.data_ptr()  # reused in place
        want, want_st = fresh(None, objs, hw, bx)
        assert torch.equal(plane, want) and torch.equal(st, want_st)
    step.release()
    plane, _ = step(None, objs_p, hw, sets[0])
    assert plane.data_ptr() != first.data_ptr()  # a fresh plane after release
    with pytest.raises(ValueError):
        make_solid_render_step((H, W), pad, stat="mean", device="cpu")


def test_throughput_sweep_smoke():
    bundles = [load_bundle("data/squarespace"), load_bundle("data/audio_book")]
    result = throughput_sweep(bundles, ["1:1", "16:9"], batch_per_ratio=2, warmup=1,
                              reps=1, device="cpu")
    assert set(result["ratios"]) == {"1:1", "16:9"}
    assert result["canvases_per_sec"] > 0
    assert result["total_canvases"] == 4


@pytest.mark.parametrize("superbatch", [0, 2])
def test_throughput_sweep_pallas_smoke(superbatch):
    bundles = [load_bundle("data/squarespace")]
    result = throughput_sweep(bundles, ["1:1"], batch_per_ratio=2, warmup=0, reps=1,
                              kernel="pallas", superbatch=superbatch, device="cpu")
    r = result["ratios"]["1:1"]
    assert result["canvases_per_sec"] > 0
    assert result["total_canvases"] == 2 * max(1, superbatch)
    assert r["superbatch"] == superbatch


def test_sweep_asks_for_its_device_and_has_no_mesh(monkeypatch):
    """The sweep runs on the device it is given, or on a mesh's (here a
    world of one over gloo; the sharded sweep against JAX's:
    tests/test_torch_mesh.py), and asking for CUDA without a card raises."""
    from image_transformation_tpu_torch.parallel.mesh import make_mesh

    bundles = [load_bundle("data/audio_book")]
    mesh = make_mesh(device="cpu", backend="gloo")
    try:
        r = throughput_sweep(bundles, ["1:1"], 2, (64, 48), mesh=mesh, warmup=0, reps=1)
    finally:
        mesh.close()
    assert r["total_canvases"] == 2 and r["ratios"]["1:1"]["batch"] == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        throughput_sweep(bundles, ["1:1"], 2)
    with pytest.raises(RuntimeError, match="is_available"):
        make_solid_render_step((100, 100), (64, 64))
