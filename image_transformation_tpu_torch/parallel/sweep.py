"""Batch placement helpers.

Port of image_transformation_tpu/parallel/sweep.py, so far only
:func:`random_downscale_boxes` (a numpy copy); the batched render step and
the throughput sweep come with the batched bench path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def random_downscale_boxes(
    rng: np.random.Generator,
    obj_hw: np.ndarray,
    canvas_hw: Tuple[int, int],
) -> np.ndarray:
    """Solver-realistic random placements (downscale-only, inside canvas)."""
    n = obj_hw.shape[0]
    H, W = canvas_hw
    boxes = np.zeros((n, 4), np.int32)
    for k in range(n):
        oh, ow = int(obj_hw[k, 0]), int(obj_hw[k, 1])
        if oh == 0 or ow == 0:
            continue
        s = float(rng.uniform(0.3, 1.0))
        s = min(s, H / oh, W / ow, 1.0)
        w, h = max(1, int(ow * s)), max(1, int(oh * s))
        x1 = int(rng.integers(0, max(1, W - w)))
        y1 = int(rng.integers(0, max(1, H - h)))
        boxes[k] = (x1, y1, x1 + w, y1 + h)
    return boxes
