"""The port's image ops: the names image_transformation_tpu/ops/__init__.py
exports, on torch tensors. Importing this package builds and loads no CUDA
code; the kernels are built at their first launch (``ops/_build.py``)."""

from .background import (
    masked_median_rgb,
    edge_strip_medians,
    axis_variance,
    solid_canvas,
    gradient_canvas,
)
from .resize import (
    build_coeffs_host,
    resample_coeff_matrix,
    resize_exact_u8,
    resize_u8,
)
from .compose import (
    alpha_over_u8,
    composite_batch,
    composite_canvas,
    composite_canvas_tables,
    composite_exact,
    paste_object,
)
from .compose_kernels import (
    composite_batch_aligned,
    composite_batch_hybrid,
    composite_batch_pallas,
    composite_batch_pallas_host_tables,
)
from .contact_sheet import (
    build_contact_sheet_from_results,
    build_labeled_contact_sheet,
    thumbnail_exact_u8,
    thumbnail_size,
)

__all__ = [
    "masked_median_rgb",
    "edge_strip_medians",
    "axis_variance",
    "solid_canvas",
    "gradient_canvas",
    "build_coeffs_host",
    "resample_coeff_matrix",
    "resize_exact_u8",
    "resize_u8",
    "alpha_over_u8",
    "composite_batch",
    "composite_canvas",
    "composite_canvas_tables",
    "composite_exact",
    "paste_object",
    "composite_batch_hybrid",
    "composite_batch_pallas",
    "composite_batch_pallas_host_tables",
    "build_contact_sheet_from_results",
    "build_labeled_contact_sheet",
    "thumbnail_exact_u8",
    "thumbnail_size",
    "composite_batch_aligned",
]
