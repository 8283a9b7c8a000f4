"""K2's live-tile walk on the CPU: ``compose_kernels._v3_live_tiles``, the
tiles the walk hands out, equals an explicit enumeration of the blocks of
a grid over the envelope (one block per placement and 32x32 tile) that
pass the resample's and the blend's per-tile exits (the extent of the
meta's rectangle: ``csrc/fused_v3.cu``'s V3Rects, and
``csrc/box_blend.cuh``'s ``tile_past``), for clamped, dropped, plain-copy
and edge sizes. The card's walk against K2's plain version is in
``tests/test_torch_fused_v3_cuda.py`` and
``tests/test_torch_gradient_step_cuda.py``."""

import numpy as np
import pytest
import torch

from image_transformation_tpu_torch.ops import compose_kernels as ck
from tests.test_torch_v3_tables import UHD_ENV, UHD_OBJ_HW, UHD_PAD, _meta, _uhd_sizes

TILE = 32
#: output sizes at and around a tile's edge
EDGE_SIZES = (0, 1, 31, 32, 33, 63, 64, 65)


def _walk_campaign(name):
    """(meta, envelope) of one case."""
    if name == "score916":  # the cell's 48 (object, level) boxes under its envelope
        return _meta(np.asarray(UHD_OBJ_HW)[None], _uhd_sizes()), UHD_ENV
    if name == "edges":  # every pair of sizes at a tile's edge, some past the envelope
        out = np.array([[h, w] for h in EDGE_SIZES for w in EDGE_SIZES])[None]
        return _meta([[[40, 40]]], out), (64, 33)
    if name == "clamped_dropped_same":
        out = [[[5000, 40], [70, 9000], [-3, 50], [50, -7], [64, 64], [64, 64], [33, 1]]]
        return (_meta([[[64, 64]]], out, same=[[0, 0, 0, 0, 1, 0, 1]],
                      valid=[[1, 1, 1, 1, 1, 0, 1]]), (96, 160))
    if name == "random":
        rng = np.random.default_rng(3)
        meta = _meta([[[50, 70]]], rng.integers(-20, 300, (5, 7, 2)),
                     same=rng.integers(0, 2, (5, 7)), valid=rng.integers(-1, 2, (5, 7)))
        return meta, (250, 190)
    raise KeyError(name)


def _envelope_blocks(meta, env):
    """Per placement, the blocks of the envelope grid (B*N, ceil(mw / 32),
    ceil(mh / 32)) that pass each kernel's early exit, as the kernels test
    it: (resample, blend) int64 [B, N]."""
    mh, mw = env
    B, N, _ = meta.shape
    resample, blend = np.zeros((B, N), np.int64), np.zeros((B, N), np.int64)
    for b in range(B):
        for k in range(N):
            row = meta[b, k].tolist()
            valid = row[5] > 0
            out_h, out_w = min(max(row[8], 0), mh), min(max(row[9], 0), mw)
            rect_w, rect_h = (out_w, out_h) if valid else (0, 0)  # V3Rects
            for tx in range(-(-mw // TILE)):
                for ty in range(-(-mh // TILE)):
                    c0, r0 = TILE * tx, TILE * ty
                    resample[b, k] += not (not valid or c0 >= out_w or r0 >= out_h)
                    blend[b, k] += not (c0 >= rect_w or r0 >= rect_h)
    return torch.from_numpy(resample), torch.from_numpy(blend)


@pytest.mark.parametrize("case", ["score916", "edges", "clamped_dropped_same", "random"])
def test_live_tiles_are_the_envelope_blocks_that_pass_the_early_exits(case):
    meta, env = _walk_campaign(case)
    resample, blend = _envelope_blocks(meta, env)
    live = ck._v3_live_tiles(meta, env)
    assert live.dtype == torch.int64 and tuple(live.shape) == tuple(meta.shape[:2])
    assert torch.equal(live, resample)
    assert torch.equal(live, blend)


def test_live_tiles_at_a_tiles_edge():
    """Sizes 1, 31, 32, 33 take 1, 1, 1, 2 tiles an axis; a dropped
    placement and one of size 0 take none; sizes past the envelope count
    the envelope's tiles."""
    meta = _meta([[[40, 40]]], [[[1, 1], [31, 32], [33, 33], [32, 65], [0, 50], [50, 50],
                                 [900, 900]]], valid=[[1, 1, 1, 1, 1, 0, 1]])
    live = ck._v3_live_tiles(meta, (100, 70))
    assert live.tolist() == [[1, 1, 4, 3, 0, 0, 4 * 3]]


def test_score916_boxes_leave_three_quarters_of_the_envelope_tiles_empty():
    """At the cell's 48 (object, level) boxes under its 1216 x 2176 envelope
    (38 x 68 tiles), the walk hands out 31,172 of the envelope's 124,032
    tiles (25.1%): an envelope grid launches the other 74.9% of its blocks
    for nothing."""
    meta, env = _walk_campaign("score916")
    live = int(ck._v3_live_tiles(meta, env).sum())
    assert meta.shape[:2] == (12, 4) and -(-env[0] // TILE) * -(-env[1] // TILE) == 38 * 68
    assert live == 31172 and meta.shape[0] * meta.shape[1] * 38 * 68 == 124032


def test_grid_query_needs_a_cuda_device():
    with pytest.raises(ValueError):
        ck._v3_grid(4, 4, UHD_PAD, UHD_ENV, "cpu")
