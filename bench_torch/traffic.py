"""The one traffic generator. Every mix file under ``mixes/`` is read here:
box pools, Flex layouts, ratios, backgrounds, Poisson arrivals and Zipf
popularity, all drawn from ``--seed``."""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np

JUSTIFY = ("start", "center", "end", "space_between", "space_around")
ALIGN = ("start", "center", "end")


def downscale_boxes(rng: np.random.Generator, obj_hw: np.ndarray,
                    canvas_hw: Tuple[int, int]) -> np.ndarray:
    """One canvas's placements, int32 [N, 4]: each object at a scale drawn
    from U(0.3, 1.0), never past its own size or the canvas, at a uniform
    origin inside the canvas (the sweep's ``random_downscale_boxes``)."""
    H, W = canvas_hw
    boxes = np.zeros((obj_hw.shape[0], 4), np.int32)
    for k, (oh, ow) in enumerate(obj_hw.tolist()):
        if oh == 0 or ow == 0:
            continue
        s = min(float(rng.uniform(0.3, 1.0)), H / oh, W / ow, 1.0)
        w, h = max(1, int(ow * s)), max(1, int(oh * s))
        x1 = int(rng.integers(0, max(1, W - w)))
        y1 = int(rng.integers(0, max(1, H - h)))
        boxes[k] = (x1, y1, x1 + w, y1 + h)
    return boxes


def box_pool(rng: np.random.Generator, obj_hw: np.ndarray, canvas_hw: Tuple[int, int],
             sets: int, batch: int) -> np.ndarray:
    """int32 [sets, batch, N, 4] placements."""
    return np.stack([np.stack([downscale_boxes(rng, obj_hw, canvas_hw) for _ in range(batch)])
                     for _ in range(sets)])


def _container(rng: np.random.Generator, children: List[Dict], depth: int,
               spacing: Dict) -> Dict:
    node = {"type": "flex", "direction": ("row", "column")[int(rng.integers(2))],
            "justify": JUSTIFY[int(rng.integers(len(JUSTIFY)))],
            "align": ALIGN[int(rng.integers(len(ALIGN)))],
            "gap_px": int(rng.integers(0, spacing["gap_max"] + 1)),
            "children": children}
    if depth > 0:
        node["padding_px"] = int(rng.integers(0, spacing["padding_max"] + 1))
    return node


def flex_layout(rng: np.random.Generator, object_ids: Sequence[int], spacing: Dict) -> Dict:
    """One Flex-DSL document: a row or column root over a random non-empty
    subset of the objects in random order, where a run of two or more may
    sit in a nested container (depth <= 2), with random justify, align and
    gaps, and nested paddings."""
    ids = [int(v) for v in object_ids]
    k = int(rng.integers(1, len(ids) + 1))
    chosen = [ids[i] for i in rng.permutation(len(ids))[:k]]
    leaves: List[Dict] = [{"object_id": oid} for oid in chosen]
    if k >= 3 and rng.random() < 0.5:
        a = int(rng.integers(0, k - 1))
        b = int(rng.integers(a + 2, k + 1))
        leaves = leaves[:a] + [_container(rng, leaves[a:b], 1, spacing)] + leaves[b:]
    return {"root": _container(rng, leaves, 0, spacing)}


def unique_layouts(rng: np.random.Generator, object_ids: Sequence[int], n: int,
                   spacing: Dict) -> List[Dict]:
    """``n`` distinct layouts."""
    seen, out = set(), []
    while len(out) < n:
        doc = flex_layout(rng, object_ids, spacing)
        key = json.dumps(doc, sort_keys=True)
        if key not in seen:
            seen.add(key)
            out.append(doc)
    return out


def poisson_arrivals(rng: np.random.Generator, rate: float, seconds: float) -> np.ndarray:
    """Send times (s from the window's start) of a Poisson process."""
    gaps = rng.exponential(1.0 / rate, size=int(rate * seconds * 1.5) + 64)
    t = np.cumsum(gaps)
    while t[-1] < seconds:
        t = np.concatenate([t, t[-1] + np.cumsum(rng.exponential(1.0 / rate, size=len(t)))])
    return t[t < seconds]


def zipf_indices(rng: np.random.Generator, n_items: int, s: float, size: int) -> np.ndarray:
    """``size`` draws over ``n_items`` ranks with P(rank i) ~ 1 / i^s."""
    p = 1.0 / np.arange(1, n_items + 1) ** s
    return rng.choice(n_items, size=size, p=p / p.sum())
