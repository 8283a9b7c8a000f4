"""The reference compositor API (PIL in / PIL out) on the port.

Counterpart of the root ``compositor.py``: the same call surface plus
``device``. The pixel work is ``ops.compose.composite_exact`` (K1 on a
CUDA device, its plain version on the CPU): host-built Pillow tables and
Pillow's fixed-point alpha-over, bit-exact vs PIL.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from PIL import Image

from ..core.bundle import load_object_images  # noqa: F401  (the reference module's name)
from ..core.device import resolve_device
from ..ops.compose import composite_exact


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def composite(
    background_img: Image.Image,
    object_images: Dict[int, Image.Image],
    placements: List[Dict],
    device: str = "cuda",
) -> Image.Image:
    """Composite objects onto the background according to placements.

    placements: list of {object_id, box: [x1,y1,x2,y2]}; list order is
    z-order. Unknown object ids are skipped, box sides floor at 1px. The
    compose runs on ``device``.
    """
    dev = resolve_device(device)
    live = [p for p in placements if int(p["object_id"]) in object_images]
    canvas = np.asarray(background_img.convert("RGBA"))
    if not live:
        return Image.fromarray(canvas.copy(), "RGBA")

    # objects padded to a shared bucketed shape, as the root shim does
    n = len(live)
    max_h = max(object_images[int(p["object_id"])].size[1] for p in live)
    max_w = max(object_images[int(p["object_id"])].size[0] for p in live)
    pad_h, pad_w = _round_up(max_h, 64), _round_up(max_w, 64)

    objs = np.zeros((n, pad_h, pad_w, 4), np.uint8)
    hw = np.zeros((n, 2), np.int32)
    boxes = np.zeros((n, 4), np.int32)
    for k, p in enumerate(live):
        arr = np.asarray(object_images[int(p["object_id"])].convert("RGBA"))
        objs[k, : arr.shape[0], : arr.shape[1]] = arr
        hw[k] = arr.shape[:2]
        boxes[k] = [int(v) for v in p["box"]]

    out = composite_exact(torch.from_numpy(canvas.copy()).to(dev), torch.from_numpy(objs).to(dev),
                          hw, boxes)
    return Image.fromarray(out.cpu().numpy(), "RGBA")
