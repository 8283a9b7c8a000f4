"""The facts K1's and K2's tap-bounded kernels rely on, held on the CPU.

K1 (csrc/fused_compose.cu) learns each table row's window from the tables
themselves (first and one-past-last nonzero tap) and resamples and blends
only inside each placement's live extent; K2 (csrc/fused_v3.cu) walks each
row's window as ``ops.resize.row_windows`` computes it and keeps a tile's
coefficients in an array of ``coeff_cap`` entries (csrc/resample.cuh).
Here, on the plain versions: restricting every table row to its window
changes no output, a
placement's pixels past its extent are transparent (so blending only the
extent changes no canvas), the windows hold every nonzero tap of the f32
tables, and the capacity bound holds. Tolerance 0 throughout (integers).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.ops.compose import _blend_window
from image_transformation_tpu_torch.ops.resize import (
    build_coeffs_traced,
    resize_with_tables,
    row_windows,
)

BUNDLES = ["squarespace", "audio_book"]
H, W = 300, 420


def _restricted(table: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """``table`` [..., rows, taps] with every tap outside its row's window
    [lo, hi) set to 0."""
    taps = torch.arange(table.shape[-1])
    inside = (taps >= win[..., :1]) & (taps < win[..., 1:2])
    return torch.where(inside, table, torch.zeros_like(table))


def _boxes(arrays, case: str, seed: int) -> np.ndarray:
    """[1, N, 4] boxes on a W x H canvas: 1-px, identity or random scales."""
    rng = np.random.default_rng(seed)
    out = []
    for oh, ow in arrays.obj_hw.tolist():
        if case == "one_px":
            bh, bw = 1, 1
        elif case == "identity":
            bh, bw = oh, ow
        else:
            bh, bw = (max(1, int(v * rng.uniform(0.05, 1.5))) for v in (oh, ow))
        x, y = int(rng.integers(0, W - 1)), int(rng.integers(0, H - 1))
        out.append((x, y, x + bw, y + bh))
    return np.asarray(out, np.int64)[None]


@pytest.mark.parametrize("tables", ["host", "traced"])
@pytest.mark.parametrize("case", ["one_px", "identity", "random"])
@pytest.mark.parametrize("bundle_name", BUNDLES)
def test_windows_and_extents_leave_the_compose_unchanged(bundle_name, case, tables):
    arrays = load_bundle(f"data/{bundle_name}").to_arrays()
    boxes = _boxes(arrays, case, seed=len(bundle_name) + len(case))
    hw = arrays.obj_hw[None]
    ph, pw = arrays.objects.shape[1:3]
    mh, mw = ph + 40, pw + 40  # the envelope admits upscales
    kh, kv, bx, fl = (torch.from_numpy(a) for a in
                      ck.fused_tables_prep(hw, boxes, (H, W), (ph, pw), (mh, mw)))
    if tables == "traced":  # the f32 tables the traced paths feed K1
        bw = torch.from_numpy((boxes[..., 2] - boxes[..., 0]).clip(1))
        bh = torch.from_numpy((boxes[..., 3] - boxes[..., 1]).clip(1))
        kh = build_coeffs_traced(torch.from_numpy(hw[..., 1]), bw, pw, mw)
        kv = build_coeffs_traced(torch.from_numpy(hw[..., 0]), bh, ph, mh)
    hwin, vwin, ext = ck.k1_tap_windows_reference(kh, kv, bx, fl, (H, W))
    assert torch.equal(_restricted(kh, hwin), kh)  # every nonzero tap is inside
    assert torch.equal(_restricted(kv, vwin), kv)
    rng = np.random.default_rng(0)
    for k, obj in enumerate(torch.from_numpy(arrays.objects)):
        ident = bool(fl[0, k] & ck.FLAG_IDENTITY)
        full = resize_with_tables(obj, kh[0, k], kv[0, k], ident)
        cut = resize_with_tables(obj, _restricted(kh[0, k], hwin[0, k]),
                                 _restricted(kv[0, k], vwin[0, k]), ident)
        assert torch.equal(cut, full), k
        ew, eh = ext[0, k].tolist()
        assert (ew, eh) != (0, 0)  # every origin is on the canvas
        assert not full[eh:, :, 3].any() and not full[:, ew:, 3].any(), k
        canvas = torch.from_numpy(rng.integers(0, 256, (H, W, 4), dtype=np.uint8))
        x, y = int(boxes[0, k, 0]), int(boxes[0, k, 1])
        whole = _blend_window(canvas.clone(), full, x, y)
        live = _blend_window(canvas.clone(), full[:eh, :ew], x, y)
        assert torch.equal(live, whole), k


def test_extents_and_windows_of_sparse_tables_match_a_loop():
    rng = np.random.default_rng(5)
    kh = torch.from_numpy(rng.integers(-3, 4, (2, 3, 9, 11)) * (rng.random((2, 3, 9, 11)) < 0.2))
    kv = torch.from_numpy(rng.integers(-3, 4, (2, 3, 7, 5)) * (rng.random((2, 3, 7, 5)) < 0.2))
    boxes = torch.tensor([[[0, 0, 1, 1], [-1, 0, 3, 3], [4, 4, 9, 9]],
                          [[2, 3, 4, 5], [5, 1, 6, 2], [1, 5, 2, 9]]], dtype=torch.int32)
    flags = torch.tensor([[1, 1, 3], [1, 0, 1]], dtype=torch.uint8)
    hwin, vwin, ext = ck.k1_tap_windows_reference(kh.int(), kv.int(), boxes, flags, (5, 6))
    for t, win in ((kh, hwin), (kv, vwin)):
        for idx in np.ndindex(*t.shape[:3]):
            nz = torch.nonzero(t[idx]).flatten().tolist()
            want = [nz[0], nz[-1] + 1] if nz else [0, 0]
            assert win[idx].tolist() == want, idx
    for b in range(2):
        for k in range(3):
            x, y = boxes[b, k, :2].tolist()
            if not flags[b, k] & 1 or x < 0 or y < 0 or x >= 6 or y >= 5:
                want = [0, 0]
            elif flags[b, k] & 2:
                want = [9, 5]  # the pad: min(mw, pw), min(mh, ph)
            else:
                rows = [[r + 1 for r in range(t.shape[2]) if t[b, k, r].any()] or [0]
                        for t in (kh, kv)]
                want = [max(rows[0]), max(rows[1])]
            assert ext[b, k].tolist() == want, (b, k)


# in, out, out_max, out_offset of one table axis
TRACED_CASES = {
    "one_px": (357, 1, 8, 0),
    "identity": (207, 207, 216, 0),
    "upscale": (37, 150, 160, 0),
    "downscale": (357, 41, 48, 0),
    "offset_row": (120, 53, 80, 17),
}


@pytest.mark.parametrize("case", sorted(TRACED_CASES))
def test_row_windows_hold_every_traced_tap(case):
    n_in, n_out, out_max, off = TRACED_CASES[case]
    in_max = n_in + 5
    table = build_coeffs_traced(torch.tensor(n_in), torch.tensor(n_out), in_max, out_max,
                                out_offset=torch.tensor(off))
    win = row_windows(torch.tensor(n_in), torch.tensor(n_out), out_max,
                      out_offset=torch.tensor(off))
    assert tuple(win.shape) == (out_max, 2)
    assert torch.equal(_restricted(table, win), table)
    live = (win[:, 1] > win[:, 0]).tolist()
    assert live == [off <= o < off + n_out for o in range(out_max)]
    assert win[:, 1].max() <= n_in
    # a table restricted to the windows resamples an image the same
    rng = np.random.default_rng(len(case))
    img = torch.from_numpy(rng.integers(0, 256, (n_in, 9, 4), dtype=np.uint8))
    ident = torch.eye(9, dtype=torch.int32) << 22
    got = resize_with_tables(img, ident, _restricted(table, win)[:, :n_in], False)
    assert torch.equal(got, resize_with_tables(img, ident, table[:, :n_in], False))


def _coeff_cap(in_max: int, lanes: int) -> int:
    """csrc/resample.cuh's coeff_cap, its formula read from the header."""
    src = (Path(ck.__file__).parents[1] / "csrc" / "resample.cuh").read_text()
    m = re.search(r"dense = lanes \* in_max, bounded = (\d+) \* in_max \+ (\d+) \* lanes", src)
    assert m, "coeff_cap's formula moved"
    return min(lanes * in_max, int(m[1]) * in_max + int(m[2]) * lanes)


def test_coefficient_capacity_holds_every_tile():
    """K2 builds a 32-row tile's taps into coeff_cap(in_max, 32) entries
    (where they fit beside the core): the windows of any 32 consecutive rows
    fit, at every size pair, so no tile of a Pillow table leaves the fast
    path."""
    sizes = [(i, o) for i in (1, 2, 3, 7, 8, 31, 64, 207, 357, 384, 700)
             for o in sorted({1, 2, 3, 5, 6, 7, 13, 31, 32, 33, i // 3 + 1, i, 2 * i, 3 * i + 1})]
    ins = torch.tensor([i for i, _ in sizes])
    outs = torch.tensor([o for _, o in sizes])
    out_max = ck._round_up(int(outs.max()), 32)
    win = row_windows(ins, outs, out_max)
    lengths = (win[..., 1] - win[..., 0]).reshape(len(sizes), -1, 32).sum(-1).amax(-1)
    for (n_in, n_out), need in zip(sizes, lengths.tolist()):
        assert need <= _coeff_cap(n_in, 32), (n_in, n_out, need)
