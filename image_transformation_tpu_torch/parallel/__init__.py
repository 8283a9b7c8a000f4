"""Batched rendering (port of image_transformation_tpu/parallel/)."""

from .sweep import (
    batched_compose_step,
    make_batched_compose,
    make_gradient_render_step,
    make_solid_render_step,
    random_downscale_boxes,
    throughput_sweep,
)

__all__ = [
    "batched_compose_step",
    "make_batched_compose",
    "make_gradient_render_step",
    "make_solid_render_step",
    "random_downscale_boxes",
    "throughput_sweep",
]
