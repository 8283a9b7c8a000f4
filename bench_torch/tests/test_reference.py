"""The plain reference against Pillow, and against the program's CPU paths
(the witnesses that the reference states the upstream semantics)."""

import numpy as np
import pytest
import torch
from PIL import Image

from bench_torch import reference, traffic
from bench_torch.harness import CHECKOUT

BUNDLES = ["squarespace", "audio_book"]


def _bundle(name):
    return reference.load_bundle(CHECKOUT / "bench_torch" / "bundles" / name)


@pytest.mark.parametrize("name", BUNDLES)
def test_compose_equals_pillow_resize_and_alpha_composite(name):
    bg, objects = _bundle(name)
    rng = np.random.default_rng(7)
    for trial in range(6):
        W, H = 260, 300
        base = reference.background_canvas(bg, (W, H), ("solid", "gradient")[trial % 2])
        placements = []
        for oid, o in objects.items():
            s = float(rng.uniform(0.1, 1.3))
            w, h = max(1, int(o.shape[1] * s)), max(1, int(o.shape[0] * s))
            x, y = int(rng.integers(0, W - 1)), int(rng.integers(0, H - 1))
            placements.append((oid, [x, y, x + w, y + h]))
        pil = Image.fromarray(base.copy())
        for oid, (x1, y1, x2, y2) in placements:
            pil.alpha_composite(Image.fromarray(objects[oid]).resize(
                (x2 - x1, y2 - y1), Image.LANCZOS), dest=(x1, y1))
        got = reference.compose(base, objects, placements, "cpu").numpy()
        assert np.array_equal(got, np.asarray(pil))
        assert (reference.compose(base, objects, placements, "cpu", "7bit").numpy() != got).any()


@pytest.mark.parametrize("name", BUNDLES)
@pytest.mark.parametrize("mode", ["solid", "gradient"])
def test_background_equals_the_program_canvas(name, mode):
    from image_transformation_tpu_torch.ops.background import synthesize_canvas

    bg, _ = _bundle(name)
    for wh in [(369, 657), (985, 246)]:
        prog = synthesize_canvas(torch.from_numpy(bg.copy()), wh[0], wh[1], mode).numpy()
        assert np.array_equal(reference.background_canvas(bg, wh, mode), prog)


@pytest.mark.parametrize("name", BUNDLES)
def test_flex_solver_equals_the_program_solver(name):
    from image_transformation_tpu_torch.layout.canvas import compute_canvas_size
    from image_transformation_tpu_torch.layout.flex import solve_flex

    bg, objects = _bundle(name)
    sizes = {oid: (o.shape[1], o.shape[0]) for oid, o in objects.items()}
    docs = traffic.unique_layouts(np.random.default_rng(11), sorted(objects), 300,
                                  {"gap_max": 48, "padding_max": 24})
    for ratio in ["9:16", "1:1", "16:9", "4:1", "21:9"]:
        wh = reference.canvas_size((970, 250), ratio)
        assert wh == compute_canvas_size((970, 250), ratio, verbose=False)
        for doc in docs:
            want = [(int(p["object_id"]), list(p["box"])) for p in solve_flex(doc["root"], wh, sizes)]
            assert reference.solve(doc["root"], wh, sizes) == want


def test_coefficients_equal_the_program_tables():
    from image_transformation_tpu_torch.ops.resize import build_coeffs_host

    for n_in, n_out in [(357, 107), (207, 62), (131, 40), (62, 61), (20, 33)]:
        want = build_coeffs_host(n_in, n_out, n_in, n_out, "lanczos")
        assert np.array_equal(reference.coefficients(n_in, n_out), want.astype(np.float64))
