"""ops/resize of the port against the JAX package and PIL.

Inputs come from numpy's seeded generator and go through both packages;
both are integer-exact, so the tolerance is 0 (``np.array_equal``).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from image_transformation_tpu.ops import resize as jax_resize
from image_transformation_tpu_torch.ops import resize as port_resize

CASES = [
    (207, 357, 100, 180),  # squarespace photo downscale
    (62, 230, 62, 230),  # identity (PIL copies without resampling)
    (32, 131, 64, 262),  # 2x upscale
    (137, 257, 50, 90),
    (250, 970, 137, 534),  # background-scale downscale
    (10, 7, 33, 21),
    (5, 5, 1, 1),
]


def _port_resize(img, in_hw, out_hw, out_max):
    return port_resize.resize_exact_u8(
        torch.from_numpy(img.copy()), in_hw, out_hw, out_max
    ).numpy()


@pytest.mark.parametrize("ih,iw,oh,ow", CASES)
def test_resize_exact_matches_jax_and_pil(ih, iw, oh, ow):
    rng = np.random.default_rng(ih * 7 + ow)
    img = rng.integers(0, 256, (ih, iw, 4), dtype=np.uint8)
    out_max = (max(oh, ih), max(ow, iw))
    got = _port_resize(img, (ih, iw), (oh, ow), out_max)
    ref = np.asarray(
        jax_resize.resize_exact_u8(jnp.asarray(img), (ih, iw), (oh, ow), out_max)
    )
    assert np.array_equal(got, ref)  # whole padded buffer, zeros included
    pil = np.asarray(Image.fromarray(img, "RGBA").resize((ow, oh), Image.LANCZOS))
    assert np.array_equal(got[:oh, :ow], pil)


@pytest.mark.parametrize("w_in,h_in,w,h", [(1600, 1200, 3, 2), (2048, 64, 2, 16), (900, 1800, 40, 2)])
def test_extreme_downscale_bit_exact_without_wide_path(w_in, h_in, w, h):
    """The JAX package routes these (taps > 256) to its chunked "wide" limb
    path; the port's float64 matmuls are exact at any tap count."""
    assert jax_resize.needs_wide_accumulation(w_in, w) or (
        jax_resize.needs_wide_accumulation(h_in, h)
    )
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (h_in, w_in, 4), np.uint8)
    img[..., 3] = rng.integers(1, 256, (h_in, w_in), np.uint8)
    flat = np.full((h_in, w_in, 4), 137, np.uint8)  # lands on >>22 boundaries
    flat[..., 3] = 255
    for src in (img, flat):
        got = _port_resize(src, (h_in, w_in), (h, w), (h, w))
        pil = np.asarray(Image.fromarray(src, "RGBA").resize((w, h), Image.LANCZOS))
        assert np.array_equal(got, pil)
        ref = np.asarray(
            jax_resize.resize_exact_u8(jnp.asarray(src), (h_in, w_in), (h, w), (h, w))
        )
        assert np.array_equal(got, ref)


def test_premultiply_and_unpremultiply_match_jax_and_pil():
    vals = np.arange(256, dtype=np.uint8)
    c, a = np.meshgrid(vals, vals, indexing="ij")
    rgba = np.stack([c, c, c, a], -1).astype(np.uint8)
    t = torch.from_numpy(rgba)
    prem = port_resize.premultiply_rgba(t).numpy()
    assert np.array_equal(prem, np.asarray(jax_resize.premultiply_rgba(jnp.asarray(rgba))))
    pil_prem = np.asarray(Image.fromarray(rgba, "RGBA").convert("RGBa"))
    assert np.array_equal(prem.astype(np.uint8), pil_prem)
    un = port_resize.unpremultiply_rgba(t).numpy()
    assert np.array_equal(un, np.asarray(jax_resize.unpremultiply_rgba(jnp.asarray(rgba))))
    pil_un = np.asarray(
        Image.frombuffer("RGBa", (256, 256), rgba.tobytes()).convert("RGBA")
    )
    assert np.array_equal(un.astype(np.uint8), pil_un)


def test_resample_fixed_matches_jax_on_random_tables():
    """Arbitrary int32 tables (not only Pillow's): the float64 passes equal
    the JAX limb matmuls wherever sums stay in int32, clip8 included."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (19, 23, 4)).astype(np.int32)
    kh = rng.integers(-(1 << 17), 1 << 18, (17, 23)).astype(np.int32)
    kv = rng.integers(-(1 << 17), 1 << 18, (13, 19)).astype(np.int32)
    got = port_resize.resample_fixed(
        torch.from_numpy(img), torch.from_numpy(kh), torch.from_numpy(kv)
    ).numpy()
    ref = np.asarray(
        jax_resize.resample_fixed(
            jnp.asarray(img, jnp.float32), jnp.asarray(kh), jnp.asarray(kv)
        )
    ).astype(np.int32)
    assert np.array_equal(got, ref)


def test_build_coeffs_host_is_the_jax_table():
    for args in [(357, 100, 357, 357), (62, 62, 207, 207), (1600, 3, 1600, 8)]:
        assert np.array_equal(
            port_resize.build_coeffs_host(*args), jax_resize.build_coeffs_host(*args)
        )
