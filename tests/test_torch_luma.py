"""The run statistic's plain version (``ops.compose_kernels.packed_luma``
on a CPU tensor) against the JAX package's ``packed_luma`` and the
benchmark's float64 reference, on the CPU.

Tolerances: JAX sums float32 luminances, so rtol 1e-5 (float32 rounding
over these small canvases; at 2M pixels its sum drifts further, see the
1080p case); the plain version sums the channels exactly and
rounds once to float32, so 1e-7 relative against the float64 mean (half
a float32 unit is 6e-8).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bench_torch import reference
from image_transformation_tpu.ops import compose_pallas as jcp
from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.parallel.sweep import _luma_u8


def _plane(rng, B, H, W, fill=None):
    """A padded packed plane [B, H + 5, W + 7] (row stride > W) of random
    bytes, or of the int32 ``fill``."""
    if fill is not None:
        return torch.full((B, H + 5, W + 7), fill, dtype=torch.int32)
    return torch.from_numpy(rng.integers(-2**31, 2**31, (B, H + 5, W + 7)).astype(np.int32))


def _check_against_references(crop, against_jax=True):
    got = ck.packed_luma(crop)
    assert got.dtype == torch.float32 and got.shape == (crop.shape[0],)
    if against_jax:
        ref = np.asarray(jcp.packed_luma(jnp.asarray(crop.contiguous().numpy())))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
    u8 = ck.packed_to_u8(crop)
    want = np.array([reference.luma(u8[b]) for b in range(crop.shape[0])])
    np.testing.assert_allclose(got.numpy().astype(np.float64), want, rtol=1e-7, atol=0)


@pytest.mark.parametrize("W", [1, 3, 129, 1081])
@pytest.mark.parametrize("col", [0, 1])
def test_strided_crops_of_a_padded_plane(W, col):
    rng = np.random.default_rng(W * 10 + col)
    plane = _plane(rng, 3, 17, W)
    crop = plane[:, 2:19, col:col + W]
    assert crop.stride(1) > W and crop.stride(-1) == 1
    _check_against_references(crop)


@pytest.mark.parametrize("fill,want", [(0, 0.0), (-1, 255.0)])
def test_all_zero_and_all_255_planes(fill, want):
    crop = _plane(None, 2, 31, 130, fill)[:, :31, :130]
    _check_against_references(crop)
    np.testing.assert_allclose(ck.packed_luma(crop).numpy(), want, rtol=1e-7)


@pytest.mark.parametrize("H,W", [(1, 1), (64, 1080)])
def test_one_canvas(H, W):
    rng = np.random.default_rng(H + W)
    _check_against_references(_plane(rng, 1, H, W)[:, :H, :W])


def test_rendered_1080p_crop_is_exact():
    """A solid plane with one bright window at the benchmark's crop: the
    channel sums are exact, so the mean is the float64 one rounded once.
    (JAX's float32 sum of 2M luminances drifts 1.2e-5 from it here, past
    the rtol of the smaller cases, so it is not the reference.)"""
    plane = torch.full((2, 1920, 1152), ck.pack_rgba_scalar((200, 100, 50, 255)),
                       dtype=torch.int32)
    plane[1, 100:400, 200:900] = ck.pack_rgba_scalar((255, 254, 253, 255))
    _check_against_references(plane[:, :1920, :1080], against_jax=False)


@pytest.mark.parametrize("layout", ["contiguous", "crop", "channels_first", "every_other_pixel"])
def test_luma_u8_is_packed_luma_of_the_same_bytes(layout):
    rng = np.random.default_rng(5)
    u8 = torch.from_numpy(rng.integers(0, 256, (3, 21, 45, 4), dtype=np.uint8))
    if layout == "crop":
        u8 = u8[:, 1:, 3:40]
    elif layout == "channels_first":  # a pixel's bytes are not adjacent
        u8 = u8.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        assert u8.stride(-1) != 1
    elif layout == "every_other_pixel":  # pixels 8 bytes apart
        u8 = u8[:, :, ::2]
        assert u8.stride(-1) == 1 and u8.stride(-2) == 8
    packed = u8.contiguous().view(torch.int32).squeeze(-1)
    assert torch.equal(_luma_u8(u8), ck.packed_luma(packed))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    plane = torch.zeros((2, 8, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        ck.packed_luma(plane.to(torch.int64))
    with pytest.raises(TypeError):
        ck.packed_luma(plane.view(torch.uint8))
    with pytest.raises(ValueError):
        ck.packed_luma(plane.transpose(1, 2))
    with pytest.raises(ValueError):
        ck.packed_luma(plane[:, :, ::2])
    with pytest.raises(ValueError):
        ck.packed_luma(plane[0])
    with pytest.raises(ValueError):
        ck.packed_luma(plane.to("meta"))


def test_launch_counter_has_the_kernel_and_resets():
    ck.reset_launch_counts()
    ck.packed_luma(torch.zeros((1, 4, 4), dtype=torch.int32))
    assert ck.LAUNCHES["packed_luma"] == 0  # the plain version launches nothing
    ck.LAUNCHES["packed_luma"] = 3
    ck.reset_launch_counts()
    assert ck.LAUNCHES["packed_luma"] == 0
