"""K2's table stage on the CPU: its plain version
(``compose_kernels.fused_v3_tables_reference``), scattered back into dense
[out, in] tables, equals ``ops.resize.build_coeffs_v3`` exactly wherever a
placement's axis grows, and is 0 wherever the stage writes nothing; the
wrapper's argument checks, its CPU path and K2's chunking with the buffer.
The card's stage against this plain version is in
``tests/test_torch_gradient_step_cuda.py``."""

import math

import numpy as np
import pytest
import torch

from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.ops.resize import UPSCALE_TAPS, _grows, build_coeffs_v3

#: the squarespace cutouts (h, w) and the score916 cell's pad and envelope,
#: as its gradient step takes them
UHD_OBJ_HW = ((62, 230), (207, 357), (137, 257), (32, 131))
UHD_PAD = (208, 384)
UHD_ENV = (1216, 2176)


def _uhd_sizes():
    """[12, 4, 2] (h, w): each cutout at the cell's 12 levels, 0.5-1.0 s0."""
    s0 = math.sqrt(3840 * 2160 / (970 * 250))
    levels = s0 * np.linspace(0.5, 1.0, 12)
    hw = np.asarray(UHD_OBJ_HW, np.float64)[None, :, :] * levels[:, None, None]
    return np.maximum(1, np.rint(hw)).astype(np.int64)


def _meta(in_hw, out_hw, same=None, valid=None):
    """int32 [B, N, 10] with the given sizes, origins 0; valid unless told."""
    in_hw, out_hw = np.asarray(in_hw), np.asarray(out_hw)
    B, N = out_hw.shape[:2]
    m = np.zeros((B, N, 10), np.int64)
    m[..., 4] = 0 if same is None else same
    m[..., 5] = 1 if valid is None else valid
    m[..., 6:8] = np.broadcast_to(in_hw, (B, N, 2))
    m[..., 8:10] = out_hw
    return torch.from_numpy(m.astype(np.int32))


def _campaign(name):
    """(meta, pad, envelope) of one case."""
    if name == "score916":  # the cell's 48 (object, level) pairs, both axes grow
        sizes = _uhd_sizes()
        return _meta(np.asarray(UHD_OBJ_HW)[None], sizes), UHD_PAD, UHD_ENV
    if name == "in_1":  # a 1-px source: one tap a window; 1 -> 1 is a plain size
        return _meta([[[1, 1], [1, 1], [1, 3]]], [[[7, 40], [1, 1], [2, 1]]]), (8, 128), (64, 256)
    if name == "out_in_plus_1":  # the smallest growth, windows of 3-6 taps
        return (_meta([[[10, 2], [207, 357], [31, 127]]], [[[11, 3], [208, 358], [32, 128]]]),
                (208, 384), (216, 512))
    if name == "in_at_pad":  # in at the pad, and past it (clamped to it)
        return (_meta([[[208, 384], [300, 500]]], [[[600, 900], [700, 1000]]]),
                (208, 384), (704, 1024))
    if name == "out_clamped":  # out past the envelope renders at the envelope's size
        return (_meta([[[62, 230], [32, 131]]], [[[5000, 1345], [187, 9000]]]),
                (64, 256), (256, 1408))
    if name == "dropped_and_same":  # no entries for dropped or plain-copy placements
        return (_meta([[[62, 230], [62, 230], [62, 230], [32, 131]]],
                      [[[363, 1345], [363, 1345], [62, 230], [100, 50]]],
                      same=[[0, 0, 1, 0]], valid=[[1, 0, 1, 1]]),
                (64, 256), (384, 1408))
    raise KeyError(name)


def _scatter(entries, in_max):
    """Entries [..., P, 8] -> dense int32 [..., P, in_max]; asserts no tap
    lands at or past in_max and every window holds at most 6 taps."""
    taps, lo, hi = entries[..., :UPSCALE_TAPS], entries[..., -2].long(), entries[..., -1].long()
    assert bool((hi - lo <= UPSCALE_TAPS).all()) and bool((hi >= lo).all())
    t = torch.arange(UPSCALE_TAPS)
    inside = t < (hi - lo)[..., None]
    dense = torch.zeros((*entries.shape[:-1], in_max + UPSCALE_TAPS), dtype=torch.int32)
    dense.scatter_(-1, lo[..., None] + t, torch.where(inside, taps, 0))
    assert not bool(dense[..., in_max:].any())
    return dense[..., :in_max]


@pytest.mark.parametrize("case", ["score916", "in_1", "out_in_plus_1", "in_at_pad",
                                  "out_clamped", "dropped_and_same"])
def test_table_stage_scatters_to_build_coeffs_v3(case):
    meta, (ph, pw), (mh, mw) = _campaign(case)
    got = ck.fused_v3_tables_reference(meta, (ph, pw), (mh, mw))
    B, N = meta.shape[:2]
    cols = ck._round_up(mw, 32)
    assert got.shape == (B, N, cols + ck._round_up(mh, 32), 8) and got.dtype == torch.int32
    m = meta.long()
    live = (m[..., 5] > 0) & (m[..., 4] <= 0)
    for axis, (sl, in_col, out_col, in_max, out_max) in enumerate(
            ((slice(0, cols), 7, 9, pw, mw), (slice(cols, None), 6, 8, ph, mh))):
        part = got[:, :, sl]
        n_in, n_out = m[..., in_col].clamp(0, in_max), m[..., out_col].clamp(0, out_max)
        dense = _scatter(part, in_max)
        for b in range(B):
            for k in range(N):
                written = bool(live[b, k]) and bool(_grows(n_in[b, k], n_out[b, k]))
                if not written:
                    assert not bool(part[b, k].any()), (case, axis, b, k)
                    continue
                want = build_coeffs_v3(n_in[b, k], n_out[b, k], in_max, part.shape[2])
                assert torch.equal(dense[b, k], want), (case, axis, b, k)
                # nothing past the last tile a resample reads
                assert not bool(part[b, k, ck._round_up(int(n_out[b, k]), 32):].any())
    if case == "score916":
        assert bool(live.all()) and got.abs().sum() > 0


def test_table_stage_wrapper_rejects_bad_arguments_and_counts_no_cpu_launch():
    meta, pad, env = _campaign("out_in_plus_1")
    ck.reset_launch_counts()
    assert torch.equal(ck.fused_v3_tables(meta, pad, env),
                       ck.fused_v3_tables_reference(meta, pad, env))
    # a mixed K2 call on the CPU: its plain version, no stage launched
    plane = torch.zeros((1, 240, 640), dtype=torch.int32)
    objs_p = torch.zeros((1, 3, 4, *pad), dtype=torch.uint8)
    ck.fused_v3(plane, objs_p, meta, env)
    assert ck.LAUNCHES["fused_v3_tables"] == 0 and ck.LAUNCHES["fused_v3"] == 0
    with pytest.raises(TypeError):
        ck.fused_v3_tables(meta.long(), pad, env)
    with pytest.raises(TypeError):
        ck.fused_v3_tables(meta.numpy(), pad, env)
    with pytest.raises(ValueError):
        ck.fused_v3_tables(meta[..., :9].contiguous(), pad, env)
    with pytest.raises(ValueError):
        ck.fused_v3_tables(torch.cat([meta, meta], -1)[..., :10], pad, env)
    with pytest.raises(ValueError):
        ck.fused_v3_tables(meta, pad, (0, 512))
    with pytest.raises(ValueError):
        ck.fused_v3_tables(meta, (208, 0), env)


@pytest.mark.parametrize("env, mixed, want", [
    ((1216, 2176), True, 25),  # the UHD cell: the tables leave 25 canvases a chunk
    ((1216, 2176), False, 25),
    ((8, 128), False, 60),     # small envelopes: the whole batch in one launch
    ((8, 128), True, 60),
])
def test_k2_chunks_count_the_table_buffer(env, mixed, want):
    """A chunk's scratch, the resampled objects plus in a mixed launch the
    stage's 32 B per output position, stays within ``_V3_SCRATCH_BYTES``."""
    B, N = 60, 4
    chunk = ck._v3_chunk(B, N, *env, mixed)
    assert chunk == want
    per = N * 4 * env[0] * env[1] + (N * ck._v3_table_positions(env) * 32 if mixed else 0)
    assert chunk * per <= ck._V3_SCRATCH_BYTES
