"""The reference ``utils.labels`` module on the port (``core/labels.py``)."""

from ...core.labels import (  # noqa: F401
    ALLOWED_LABELS,
    compute_per_label_numbers,
    is_allowed_label,
    normalize_label,
)
