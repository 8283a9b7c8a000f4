"""PyTorch/CUDA port of image_transformation_tpu.

Module names mirror the JAX package. Host-only modules are copies; the
pixel path (resize, compose, background, thumbnails) is torch code on an
explicit device, and on CUDA the compose runs the hand-written kernel in
``csrc/fused_compose.cu`` (see ops/compose_kernels.py). Nothing here
imports jax or image_transformation_tpu.
"""
