"""The port's roofline (ops/roofline.py, ops/roofline_compute.py) against
the JAX package, on the CPU: the geometry helpers and the live-memory
shapes equal JAX's; the step's changed pixels and restore term equal a
count taken from JAX's own exact composite onto a transparent canvas, and
its multiply-adds a count from JAX's host tables, exactly; and the
properties of tests/test_roofline.py and tests/test_roofline_compute.py
that carry over to a work count hold for the port.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from image_transformation_tpu.ops import roofline as jax_roofline
from image_transformation_tpu.ops.compose import composite_exact as jax_composite_exact
from image_transformation_tpu.ops.resize import build_coeffs_host as jax_build_coeffs_host
from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.ops import roofline
from image_transformation_tpu_torch.ops import roofline_compute as rc
from image_transformation_tpu_torch.ops.resize import build_coeffs_host, resample_fixed
from image_transformation_tpu_torch.parallel.sweep import random_downscale_boxes

ROOT = Path(__file__).resolve().parents[1]
BUNDLES = ("squarespace", "audio_book")
H100 = "NVIDIA H100 80GB HBM3"
CANVAS = (96, 160)


def _sizes(rng, n, hi=4096):
    return [tuple(int(v) for v in rng.integers(1, hi + 1, 2)) for _ in range(n)]


def test_geometry_equals_jax_over_a_size_campaign():
    rng = np.random.default_rng(0)
    for out_hw in _sizes(rng, 300):
        assert roofline.window_extents(out_hw) == jax_roofline.window_extents(out_hw)
    for canvas, out_max in zip(_sizes(rng, 300), _sizes(rng, 300)):
        assert (roofline.fused_canvas_pad_hw(canvas, out_max)
                == jax_roofline.fused_canvas_pad_hw(canvas, out_max))
    for _ in range(200):
        static = _sizes(rng, int(rng.integers(1, 6)))
        out_max = _sizes(rng, 1)[0]
        assert (roofline.static_restore_windows(static, out_max)
                == jax_roofline.static_restore_windows(static, out_max))


@pytest.mark.parametrize("shared", [True, False])
def test_live_plane_and_object_bytes_equal_jax(shared):
    rng = np.random.default_rng(1)
    for _ in range(50):
        B, N = int(rng.integers(1, 600)), int(rng.integers(1, 9))
        canvas, pad = _sizes(rng, 1)[0], _sizes(rng, 1, 1024)[0]
        out_max = None if rng.random() < 0.5 else _sizes(rng, 1, 1024)[0]
        port = roofline.expected_live_hbm_bytes(B, N, canvas, pad, out_max, shared_objs=shared)
        jax = jax_roofline.expected_live_hbm_bytes(B, N, canvas, pad, out_max, shared_objs=shared)
        assert port["plane_bytes"] == jax["plane_bytes"]
        assert port["object_bytes"] == jax["object_bytes"]


def test_live_memory_counts_the_port_step():
    """One plane (the step renders in place, where JAX's holds two across
    its donation swap); K2's scratch covers the chunk it walks and stays
    under its 1 GiB cap."""
    pad = (207, 357)
    m = roofline.expected_live_hbm_bytes(256, 4, (1080, 1920), pad)
    assert m["planes_live"] == 1
    assert m["plane_bytes"] == 256 * 1080 * 1920 * 4
    assert m["scratch_bytes"] == 256 * 4 * 208 * 384 * 4
    assert m["meta_bytes"] == 4 * 256 * 4 * 12
    big = roofline.expected_live_hbm_bytes(4096, 4, (1080, 1920), pad)
    assert big["scratch_bytes"] <= ck._V3_SCRATCH_BYTES
    for live in (m, big):
        assert live["total_bytes"] == (live["plane_bytes"] + live["object_bytes"]
                                       + live["scratch_bytes"] + live["meta_bytes"])


def _case(name, seed=0, batch=2):
    """A bundle's arrays and B seeded downscale boxes on CANVAS, with an
    identity placement and one hanging off the right edge."""
    arrays = load_bundle(ROOT / "data" / name).to_arrays()
    rng = np.random.default_rng(seed)
    boxes = np.stack([random_downscale_boxes(rng, arrays.obj_hw, CANVAS) for _ in range(batch)])
    h0, w0 = (int(v) for v in arrays.obj_hw[0])
    boxes[1, 0] = [100, 40, 100 + w0, 40 + h0]  # identity, cut at the canvas
    x1, y1, x2, y2 = boxes[0, -1]
    boxes[0, -1] = [CANVAS[1] - 10, y1, CANVAS[1] - 10 + x2 - x1, y2]
    static = tuple(tuple(int(v) for v in row) for row in arrays.obj_hw)
    return arrays, boxes, static


def _jax_changed(arrays, boxes):
    """Pixels of alpha > 0 in JAX's exact composite of each canvas's
    placements onto a transparent canvas."""
    total = 0
    for b in range(boxes.shape[0]):
        out = np.asarray(jax_composite_exact(np.zeros((*CANVAS, 4), np.uint8), arrays.objects,
                                             arrays.obj_hw, boxes[b]))
        total += int((out[..., 3] > 0).sum())
    return total


@pytest.mark.parametrize("name", BUNDLES)
def test_step_changed_pixels_and_restore_equal_jax_composite(name):
    arrays, boxes, static = _case(name)
    B, N = boxes.shape[:2]
    pad = arrays.objects.shape[1:3]
    changed = _jax_changed(arrays, boxes)
    assert changed > 0
    m = roofline.solid_render_bytes_per_batch(B, N, CANVAS, pad, static_obj_hw=static,
                                              boxes=boxes, objects=arrays)
    assert m["window_io_bytes"] == 8 * changed
    assert m["restore_write_bytes"] == 4 * changed
    fresh = roofline.solid_render_bytes_per_batch(B, N, CANVAS, pad, static_obj_hw=static,
                                                  reuse=False, boxes=boxes, objects=arrays)
    assert fresh["restore_write_bytes"] == 4 * B * CANVAS[0] * CANVAS[1]
    assert fresh["window_io_bytes"] == m["window_io_bytes"]
    live = sum(int((arrays.objects[k, :h, :w, 3] > 0).sum())
               for k, (h, w) in enumerate(arrays.obj_hw))
    assert m["object_read_bytes"] == 4 * live
    assert m["stat_read_bytes"] == B * 512


@pytest.mark.parametrize("name", BUNDLES)
def test_resample_macs_equal_jax_host_tables(name):
    arrays, boxes, static = _case(name)
    pad = arrays.objects.shape[1:3]
    want = {"h_pass": 0, "v_pass": 0}
    for b, k in np.ndindex(boxes.shape[:2]):
        x1, y1, x2, y2 = (int(v) for v in boxes[b, k])
        ih, iw = (int(v) for v in arrays.obj_hw[k])
        oh, ow = max(1, y2 - y1), max(1, x2 - x1)
        if (oh, ow) == (ih, iw):
            continue
        want["h_pass"] += 4 * np.count_nonzero(jax_build_coeffs_host(iw, ow, iw, ow)) * ih
        want["v_pass"] += 4 * np.count_nonzero(jax_build_coeffs_host(ih, oh, ih, oh)) * ow
    work = rc.solid_render_compute_per_batch(arrays.obj_hw, boxes, CANVAS, pad,
                                             static_obj_hw=static)
    assert {k: work["stages"][k] for k in want} == want
    assert work["int_macs"] == want["h_pass"] + want["v_pass"] > 0


def test_banded_alpha_resample_equals_the_plain_resample():
    rng = np.random.default_rng(2)
    for _ in range(20):
        ih, iw = (int(v) for v in rng.integers(1, 120, 2))
        oh, ow = (int(v) for v in rng.integers(1, 160, 2))
        alpha = rng.integers(0, 256, (ih, iw)).astype(np.uint8)
        alpha[rng.random((ih, iw)) < 0.4] = 0
        kh, kv = build_coeffs_host(iw, ow, iw, ow), build_coeffs_host(ih, oh, ih, oh)
        want = resample_fixed(torch.from_numpy(alpha)[..., None], torch.from_numpy(kh),
                              torch.from_numpy(kv))[..., 0].numpy()
        np.testing.assert_array_equal(roofline.resized_alpha(alpha, kh, kv), want)


def test_bytes_terms_sum_and_scale_linearly_in_the_batch():
    arrays, boxes, static = _case("squarespace")
    pad = arrays.objects.shape[1:3]
    B, N = boxes.shape[:2]
    twice = np.concatenate([boxes, boxes])
    for shared in (True, False):
        m1 = roofline.solid_render_bytes_per_batch(B, N, CANVAS, pad, static_obj_hw=static,
                                                   shared_objs=shared, stat="luma",
                                                   boxes=boxes, objects=arrays)
        m2 = roofline.solid_render_bytes_per_batch(2 * B, N, CANVAS, pad, static_obj_hw=static,
                                                   shared_objs=shared, stat="luma",
                                                   boxes=twice, objects=arrays)
        for m in (m1, m2):
            assert m["total_bytes"] == sum(v for k, v in m.items() if k != "total_bytes")
        for term in ("restore_write_bytes", "window_io_bytes", "stat_read_bytes"):
            assert m2[term] == 2 * m1[term]
        # one shared planar copy is read once whatever the batch
        assert m2["object_read_bytes"] == m1["object_read_bytes"] * (1 if shared else 2)
    assert m1["stat_read_bytes"] == B * CANVAS[0] * CANVAS[1] * 4
    w1 = rc.solid_render_compute_per_batch(arrays.obj_hw, boxes, CANVAS, pad, static)
    w2 = rc.solid_render_compute_per_batch(arrays.obj_hw, twice, CANVAS, pad, static)
    assert w2["stages"] == {k: 2 * v for k, v in w1["stages"].items()}
    assert w1["total"] == 2 * w1["int_macs"] + w1["scalar_ops"]
    with pytest.raises(ValueError):
        roofline.solid_render_bytes_per_batch(B + 1, N, CANVAS, pad, boxes=boxes, objects=arrays)


def test_identity_boxes_add_no_resample_work():
    arrays = load_bundle(ROOT / "data" / "squarespace").to_arrays()
    boxes = np.zeros((2, arrays.obj_hw.shape[0], 4), np.int64)
    boxes[..., 2] = arrays.obj_hw[None, :, 1]
    boxes[..., 3] = arrays.obj_hw[None, :, 0]
    pad = arrays.objects.shape[1:3]
    static = tuple(tuple(int(v) for v in row) for row in arrays.obj_hw)
    work = rc.solid_render_compute_per_batch(arrays.obj_hw, boxes, (400, 400), pad, static)
    assert work["stages"]["h_pass"] == work["stages"]["v_pass"] == work["int_macs"] == 0
    assert work["stages"]["blend"] > 0  # blends still run
    # an origin off the canvas is dropped: no work at all
    boxes[0, 0, :2] = (500, 0)
    dropped = rc.solid_render_compute_per_batch(arrays.obj_hw, boxes, (400, 400), pad, static)
    assert dropped["stages"]["blend"] < work["stages"]["blend"]


def test_summarize_fields_peaks_and_nulls():
    m = {"total_bytes": 2.0e9}
    s = roofline.summarize(m, 65.0, H100)
    assert set(s) >= {"model_bytes_per_batch", "achieved_gbps", "hbm_peak_gbps",
                      "hbm_utilization", "device_name", "note"}
    assert s["achieved_gbps"] == pytest.approx(130.0)
    assert s["hbm_peak_gbps"] == 3350.0 and s["note"] is None
    assert s["hbm_utilization"] == pytest.approx(130.0 / 3350.0)
    assert roofline.hbm_peak_gbps("NVIDIA H100 PCIe") == 2000.0
    assert roofline.hbm_peak_gbps("NVIDIA H100 NVL") == 3900.0
    # unknown card -> peak and utilization null, never guessed
    s2 = roofline.summarize(m, 65.0, "NVIDIA A100-SXM4-80GB")
    assert s2["hbm_peak_gbps"] is None and s2["hbm_utilization"] is None and s2["note"]
    assert roofline.hbm_peak_gbps("") is None
    # a working set under the L2: not an HBM share
    s3 = roofline.summarize({"total_bytes": 40e6}, 1000.0, H100)
    assert s3["hbm_peak_gbps"] == 3350.0 and s3["hbm_utilization"] is None
    assert "L2" in s3["note"]


def test_summarize_compute_fields_and_unknown_card():
    arrays, boxes, static = _case("squarespace")
    work = rc.solid_render_compute_per_batch(arrays.obj_hw, boxes, CANVAS,
                                             arrays.objects.shape[1:3], static)
    s = rc.summarize_compute(work, 100.0, H100, hbm_bytes_per_batch=1e9)
    assert s["int_mac_peak_macs_per_s"] == 989.5e12 and s["int_mac_limbs"] == 3
    assert s["int_mac_sol_ms"] == pytest.approx(work["int_macs"] * 3 / 989.5e12 * 1e3)
    assert s["scalar_sol_ms"] == pytest.approx(work["total"] / 67e12 * 1e3)
    assert 0 < s["int_mac_utilization"] and 0 < s["scalar_utilization"]
    assert s["binding_unit"] in ("int_mac", "hbm") and s["compute_sol_fraction"] > 0
    assert s["hbm_sol_ms"] == pytest.approx(1e9 / 3.35e12 * 1e3)
    assert set(s["stage_sol_ms"]) == {"h_pass", "v_pass", "blend"}
    assert s["stage_sol_ms"]["blend"]["int_mac"] == 0.0
    s2 = rc.summarize_compute(work, 100.0, "NVIDIA A100-SXM4-80GB", hbm_bytes_per_batch=1e9)
    assert s2["int_mac_utilization"] is None and s2["scalar_utilization"] is None
    assert s2["int_mac_peak_macs_per_s"] is None and "binding_unit" not in s2
    with pytest.raises(ValueError):
        rc.summarize_compute(work, 0.0, H100)


def test_kernel_bounds_use_the_tensor_core_rate_and_flag_l2():
    b = roofline.bound(1e9, 1e12, 3e9, H100)
    t_ops = 1e12 * 3 / 989.5e12
    assert b["bound_by"] == "operations" and b["bound_ms"] == pytest.approx(1e3 * t_ops)
    assert b["scalar_ms"] == pytest.approx(1e3 * (2e12 + 3e9) / 67e12)
    assert not b["l2_resident"]
    small = roofline.bound(1e6, 0, 0, H100)
    assert small["bound_by"] == "bytes" and small["l2_resident"]
    assert roofline.bound(1e6)["bound_ms"] == small["bound_ms"]  # the target card on the CPU
    with pytest.raises(ValueError):
        roofline.bound(1e6, device_name="NVIDIA A100-SXM4-80GB")


def test_k2_and_k3_bounds_count_the_step_inputs():
    """K2's written pixels are the plain version's alpha > 0 on a
    transparent plane; K3's bytes are its windows' union."""
    arrays, boxes, static = _case("squarespace")
    objs_p = ck.planarize_objects(torch.from_numpy(arrays.objects)[None])
    B, N = boxes.shape[:2]
    hw = torch.from_numpy(np.broadcast_to(arrays.obj_hw, (B, N, 2)).copy())
    geo = ck.render_geometry(CANVAS, objs_p.shape[3:], N, static, pipelined=True)
    meta, env, (hp, wp) = geo.meta(hw, boxes), geo.envelope, geo.pad
    plane = torch.zeros((B, hp, wp), dtype=torch.int32)
    k2 = roofline.k2_bound(plane, objs_p, meta, env)
    written = roofline.alpha_pixels(ck.fused_v3_reference(plane.clone(), objs_p, meta, env))
    assert k2["bound_gbytes"] * 1e9 == objs_p.numel() + 4 * meta.numel() + 8 * written
    assert k2["l2_resident"] and k2["bound_gmacs"] > 0
    ext = geo.windows
    origins = meta[..., :2].contiguous()
    k3 = roofline.k3_bound(plane, origins, ext)
    assert k3["union_px"] <= k3["summed_px"]
    assert k3["bound_gbytes"] * 1e9 == 4 * k3["union_px"] + 4 * origins.numel()


def test_new_modules_import_no_jax():
    """The roofline modules and the watchdog import neither jax nor the
    JAX package (a fresh interpreter, its sys.modules read after)."""
    code = (
        "import sys\n"
        "import image_transformation_tpu_torch.ops.roofline\n"
        "import image_transformation_tpu_torch.ops.roofline_compute\n"
        "import image_transformation_tpu_torch.core.watchdog\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
        "'image_transformation_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
