# Copy of image_transformation_tpu/core/labels.py (host-only; imports rewritten to this package).
"""Canonical object-label vocabulary and per-label numbering.

Parity: reference/utils/labels.py (the taxonomy results.json uses).
Dead code in the reference (no callers) but the label set is the de-facto
schema of every bundle's metadata, so the surface is preserved.
"""

from __future__ import annotations

from collections import Counter
from typing import List

#: the six-label taxonomy used by the segmentation bundles
LABEL_VOCABULARY = (
    "button", "photo", "design element",
    "text", "logo", "cta",
)

ALLOWED_LABELS: List[str] = list(LABEL_VOCABULARY)


def normalize_label(value: str) -> str:
    """Canonical lowercase, trimmed form."""
    return (value or "").strip().lower()


def is_allowed_label(value: str) -> bool:
    return normalize_label(value) in LABEL_VOCABULARY


def compute_per_label_numbers(labels: List[str]) -> List[int]:
    """Contiguous per-label numbering, e.g. [photo, text, photo] -> [1, 1, 2]."""
    tally: Counter = Counter()
    numbers: List[int] = []
    for key in map(normalize_label, labels):
        tally[key] += 1
        numbers.append(tally[key])
    return numbers
