"""The benchmark's copy of the work model equals the program's ops/roofline.py."""

import numpy as np

from bench_torch import roofline, traffic
from bench_torch.harness import CHECKOUT


def test_render_work_equals_the_program_model():
    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.ops import roofline as prog
    from image_transformation_tpu_torch.ops import roofline_compute as prog_c

    arrays = load_bundle(CHECKOUT / "bench_torch" / "bundles" / "squarespace").to_arrays()
    H, W = 480, 400
    pool = traffic.box_pool(np.random.default_rng(5), arrays.obj_hw, (H, W), 2, 6)
    work = roofline.RenderWork(arrays.objects, arrays.obj_hw, pool, (H, W), "cpu")
    pad = arrays.objects.shape[1:3]
    static = tuple(tuple(int(v) for v in r) for r in arrays.obj_hw)
    for s in range(2):
        want = prog.solid_render_bytes_per_batch(
            6, 4, (H, W), pad, static_obj_hw=static, reuse=True, stat="luma",
            boxes=pool[s], objects=arrays)
        # the program's model restores this render's own pixels (prev == s)
        assert work.render_bytes(s, s) == (want["restore_write_bytes"] + want["window_io_bytes"]
                                           + want["object_read_bytes"])
        assert roofline.stat_bytes(6, (H, W)) == want["stat_read_bytes"] + 4 * 6
        comp = prog_c.solid_render_compute_per_batch(arrays.obj_hw, pool[s], (H, W), pad, static)
        assert work.macs(s) == comp["int_macs"]


def test_peaks_equal_the_program_tables_and_unknown_cards_have_none():
    from image_transformation_tpu_torch.ops import roofline as prog
    from image_transformation_tpu_torch.ops import roofline_compute as prog_c

    for name, peaks in prog.CARDS.items():
        assert roofline.card(name) == (peaks["hbm_bytes_per_s"], prog_c.INT_MAC_PEAK[name])
    assert roofline.card("NVIDIA A100-SXM4-80GB") is None
    assert roofline.bound_seconds(1e9, 0, "cpu") is None
    assert roofline.bound_seconds(3.35e9, 0, "NVIDIA H100 80GB HBM3") == 1e-3
