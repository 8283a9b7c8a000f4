"""The check refuses the control and the faults a cell can have.

Each run skips the look for a card and drives the rest of a run on the CPU
at a small size, with the timed path broken underneath: a step that returns
its state unchanged, half of the batch left out (the mean taken over the
rest), an answer altered where it is produced. (No cell spans chips, so no
exchange between chips can be left out.) The control puts the reference,
at the mix's lower precision, in the program's place."""

import pytest
import torch

from bench_torch import harness
from bench_torch.tests.test_run import SMALL, load

SEED = 2**31 + 5


def _run(cell, patch=None, precision="exact"):
    c = load(cell)
    return harness.run_cell(c, SEED, 0.5, False, "cpu", overrides=SMALL[cell], patch=patch,
                            precision=precision)


def _after_setup(make):
    """A patch that lets set-up run, then wraps the driver's timed call."""
    def patch(driver):
        setup = driver.setup

        def patched():
            setup()
            make(driver)

        driver.setup = patched
    return patch


# ---------------------------------------------------------------- score
def _score_frozen(d):
    step, first = d.step, []

    def frozen(*args):
        if not first:
            first.append(step(*args))
        return first[0]

    d.step = frozen


def _score_half(d):
    step = d.step

    def half(c, objs, hw, boxes):
        plane, luma = step(c, objs, hw, boxes)
        h = plane.shape[0] // 2
        plane[h:] = plane[h:, :1, :1]  # the second half left at the background
        luma = luma.clone()
        luma[h:] = luma[:h].mean()
        return plane, luma

    d.step = half


def _score_altered(d):
    step = d.step

    def altered(*args):
        plane, luma = step(*args)
        plane[:, : d.H // 2, : d.W // 2] ^= 0x80
        return plane, luma

    d.step = altered


# ---------------------------------------------------------------- draft
def _draft_unchanged(d):
    d.engine.compose = lambda placements: d.engine.canvas_dev.clone()


def _draft_box(d):
    solve = d.solve_flex

    def shifted(root, size, sizes):
        out = solve(root, size, sizes)
        out[0]["box"] = [out[0]["box"][0] + 1, *out[0]["box"][1:]]
        return out

    d.solve_flex = shifted


def _draft_png(d):
    encode = d.png_bytes

    def altered(img):
        img = img.copy()
        img[0, 0, 0] ^= 0x80
        return encode(img)

    d.png_bytes = altered


# ---------------------------------------------------------------- fleet
def _fleet_wrap(d, change):
    run = d._pass

    def wrapped(doc):
        return change(*run(doc))

    d._pass = wrapped


def _fleet_frozen(d):
    first = []

    def change(*res):
        if not first:
            first.append(res)
        return first[0]

    _fleet_wrap(d, change)


def _fleet_half(d):
    def change(prog, out, boxes, luma):
        h = out.shape[0] // 2
        out = out.clone()
        out[h:] = out[h:, :1, :1]
        luma = luma.copy()
        luma[h:] = luma[:h].mean()
        return prog, out, boxes, luma

    _fleet_wrap(d, change)


def _fleet_altered(d):
    def change(prog, out, boxes, luma):
        boxes = boxes.copy()
        boxes[:, 0, :2] += 1
        return prog, out, boxes, luma

    _fleet_wrap(d, change)


FAULTS = {
    "squarespace.score1080": [_score_frozen, _score_half, _score_altered],
    "audio_book.draft916": [_draft_unchanged, _draft_box, _draft_png],
    "squarespace.fleet8": [_fleet_frozen, _fleet_half, _fleet_altered],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(cell, fault):
    result = _run(cell, patch=_after_setup(fault))
    assert result["correct"] is False, result["checks"]


def test_an_altered_served_png_is_not_correct():
    from bench_torch.drivers import serve

    class Altering(serve.LoadGen):
        def run(self, schedule, bodies, keep=()):
            recs = super().run(schedule, bodies, keep)
            for r in recs:  # what the daemon produced, one byte of pixels changed
                if "body" in r:
                    import io

                    from PIL import Image
                    im = Image.open(io.BytesIO(r["body"])).convert("RGBA")
                    px = im.load()
                    px[0, 0] = tuple(v ^ 0x80 for v in px[0, 0][:3]) + (px[0, 0][3],)
                    buf = io.BytesIO()
                    im.save(buf, format="PNG")
                    r["body"] = buf.getvalue()
            return recs

    def patch(driver):
        setup = driver.setup

        def patched():
            setup()
            driver.load = Altering(driver.daemon.port, driver.load.workers)

        driver.setup = patched

    assert _run("audio_book.serve916", patch=patch)["correct"] is False


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_not_correct(cell):
    assert _run(cell, precision=load(cell).mix["control"])["correct"] is False
    assert torch.get_default_dtype() == torch.float32
