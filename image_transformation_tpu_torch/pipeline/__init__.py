"""The port's pipeline package (counterpart of image_transformation_tpu/pipeline/).
Importing it builds and loads no CUDA code."""

from .fused import fused_multi_ratio_render, make_fused_render, make_sharded_fused_render
