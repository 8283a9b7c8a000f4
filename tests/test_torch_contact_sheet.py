"""ops/contact_sheet of the port against the JAX package and PIL
(tolerance 0)."""

import numpy as np
import pytest
import torch
from PIL import Image

from image_transformation_tpu.core.bundle import load_bundle as jax_load_bundle
from image_transformation_tpu.ops import contact_sheet as jax_cs
from image_transformation_tpu_torch.ops import contact_sheet as port_cs

CPU = torch.device("cpu")


@pytest.mark.parametrize(
    "h,w,target",
    [(207, 357, (256, 256)), (62, 230, (256, 256)), (600, 90, (256, 256)),
     (300, 300, (64, 48)), (40, 30, (256, 256))],
)
def test_thumbnail_matches_jax_and_pil(h, w, target):
    rng = np.random.default_rng(h * 31 + w)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    got = port_cs.thumbnail_exact_u8(img, target, device=CPU)
    assert np.array_equal(got, jax_cs.thumbnail_exact_u8(img, target))
    pil = Image.fromarray(img, "RGBA")
    pil.thumbnail(target, Image.LANCZOS)
    assert np.array_equal(got, np.asarray(pil))


def test_labeled_contact_sheet_matches_jax():
    bundle = jax_load_bundle("data/audio_book")
    labels = bundle.id_to_label()
    got = port_cs.build_labeled_contact_sheet(bundle.objects, labels, device=CPU)
    ref = jax_cs.build_labeled_contact_sheet(bundle.objects, labels)
    assert got.size == ref.size
    assert np.array_equal(np.asarray(got), np.asarray(ref))
