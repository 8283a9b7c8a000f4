"""The multi-ratio fused render on the card: make_fused_render(kernel="pallas")
with CUDA tensors (the device solve, the plane and K2) against the same
step on CPU tensors (the plain versions). Canvases, boxes and scales must
be byte-equal; the luma within rtol 1e-5 (float32 sums in another order).

Every test here is marked ``cuda`` and skips without a card:
``python -m pytest tests/test_torch_fused_render_cuda.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch

from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.layout.canvas import compute_canvas_size
from image_transformation_tpu_torch.layout.solve import FlexProgram
from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.pipeline import fused


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 has no CPU mode")
    return torch.device("cuda", 0)


def _run(bundle_name, ratios, background, device, static=False, budget=None):
    bundle = load_bundle(f"data/{bundle_name}")
    root = {"type": "flex", "direction": "column", "children": [
        {"object_id": oid, "name": bundle.meta[oid].label} for oid in bundle.object_ids()]}
    sizes = [compute_canvas_size(budget or bundle.background.size, r, verbose=False)
             for r in ratios]
    arrays = bundle.to_arrays()
    prog = FlexProgram.from_dsl(root)
    objs, obj_wh, known = fused.map_bundle_to_program(prog, bundle, arrays)
    bg, horizontal = fused.background_spec(
        torch.from_numpy(np.array(bundle.background)).to(device), background)
    static_hw = tuple((int(h), int(w)) for w, h in obj_wh) if static else None
    step = fused.make_fused_render(
        prog, (max(h for _, h in sizes), max(w for w, _ in sizes)), arrays.objects.shape[1:3],
        kernel="pallas", background=background, gradient_horizontal=horizontal,
        static_obj_hw=static_hw)
    out = step(torch.tensor(sizes, dtype=torch.int32, device=device), bg,
               torch.from_numpy(objs).to(device), torch.from_numpy(obj_wh).to(device),
               torch.from_numpy(known).to(device))
    return [t.cpu() for t in out]


def _assert_card_equals_plain(card, plain):
    for name, a, b in zip(("canvases", "boxes", "scales"), card[:3], plain[:3]):
        assert torch.equal(a, b), name
    torch.testing.assert_close(card[3], plain[3], rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("background", ["solid", "gradient"])
@pytest.mark.parametrize("ratios", [["9:16", "16:9"], ["9:16", "4:1"]])
def test_card_equals_plain_version(cuda, background, ratios):
    ck.reset_launch_counts()
    card = _run("squarespace", ratios, background, cuda)
    assert ck.LAUNCHES["fused_v3"] == 1
    _assert_card_equals_plain(card, _run("squarespace", ratios, background, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("background", ["solid", "gradient"])
def test_static_obj_hw_changes_nothing(cuda, background):
    ratios = ["9:16", "1:1", "4:1"]
    with_static = _run("audio_book", ratios, background, cuda, static=True)
    without = _run("audio_book", ratios, background, cuda)
    for a, b in zip(with_static, without):
        assert torch.equal(a, b)
    _assert_card_equals_plain(with_static, _run("audio_book", ratios, background, "cpu"))


@pytest.mark.cuda
def test_variants_past_the_scratch_chunk(cuda, monkeypatch):
    """K2's wrapper walks the variants in chunks that keep its scratch under
    ``_V3_SCRATCH_BYTES``; with the limit at three variants' scratch, 8
    variants take three chunks and one call."""
    arrays = load_bundle("data/squarespace").to_arrays()
    n, ph, pw = arrays.objects.shape[:3]
    mh, mw = ck._round_up(ph, 8), ck._round_up(pw, 128)  # K2's envelope
    monkeypatch.setattr(ck, "_V3_SCRATCH_BYTES", 3 * n * 4 * mh * mw)
    ratios = ["9:16", "1:1", "16:9", "4:1", "4:5", "3:2", "2:3", "21:9"]
    ck.reset_launch_counts()
    card = _run("squarespace", ratios, "gradient", cuda, budget=(640, 360))
    assert ck.LAUNCHES["fused_v3"] == 1
    _assert_card_equals_plain(card, _run("squarespace", ratios, "gradient", "cpu",
                                         budget=(640, 360)))
