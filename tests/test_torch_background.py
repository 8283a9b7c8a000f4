"""ops/background of the port against the JAX package (tolerance 0)."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from image_transformation_tpu.layout.canvas import compute_canvas_size
from image_transformation_tpu.ops import background as jax_bg
from image_transformation_tpu_torch.ops import background as port_bg

BUNDLES = ["squarespace", "audio_book"]


def _bg(bundle_name):
    return np.asarray(
        Image.open(f"data/{bundle_name}/background.png").convert("RGBA")
    ).copy()


@pytest.mark.parametrize("mode", ["solid", "gradient"])
@pytest.mark.parametrize("bundle_name", BUNDLES)
@pytest.mark.parametrize("ratio", ["9:16", "16:9", "1:1"])
def test_synthesize_canvas_matches_jax(bundle_name, mode, ratio):
    bg = _bg(bundle_name)
    W, H = compute_canvas_size((bg.shape[1], bg.shape[0]), ratio, verbose=False)
    got = port_bg.synthesize_canvas(torch.from_numpy(bg), W, H, mode).numpy()
    ref = np.asarray(jax_bg.synthesize_canvas(jnp.asarray(bg), W, H, mode))
    assert got.shape == (H, W, 4) and got.dtype == np.uint8
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("seed", range(6))
def test_masked_median_rgb_matches_jax_and_numpy(seed):
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(1, 40, 2))
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    if seed % 3 == 0:
        img[..., 3] = 0  # all transparent: median over every pixel
    elif seed % 3 == 1:
        img[..., 3] *= rng.random((h, w)) < 0.5
    got = port_bg.masked_median_rgb(torch.from_numpy(img)).numpy()
    ref = np.asarray(jax_bg.masked_median_rgb(jnp.asarray(img)))
    assert np.array_equal(got, ref)
    flat = img.reshape(-1, 4)
    sel = flat[flat[:, 3] > 0] if (flat[:, 3] > 0).any() else flat
    expect = [int(np.median(sel[:, c])) for c in range(3)]
    assert got.tolist() == expect


@pytest.mark.parametrize("bundle_name", BUNDLES)
def test_gradient_spec_and_edge_medians_match_jax(bundle_name):
    bg = _bg(bundle_name)
    spec = port_bg.gradient_spec(torch.from_numpy(bg))
    assert spec == jax_bg.gradient_spec(jnp.asarray(bg))
    for got, ref in zip(
        port_bg.edge_strip_medians(torch.from_numpy(bg)),
        jax_bg.edge_strip_medians(jnp.asarray(bg)),
    ):
        assert got.tolist() == np.asarray(ref).tolist()


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        port_bg.synthesize_canvas(torch.zeros((4, 4, 4), dtype=torch.uint8), 4, 4, "plaid")
