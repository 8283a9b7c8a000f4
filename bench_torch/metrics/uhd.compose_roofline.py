"""uhd.compose_roofline: the upscaling compose's share of its roofline, in percent.

K2 resamples and blends each step's placements: 8 bytes a changed pixel
(read and written), the placed objects read once, and the exact two-pass
resample's multiply-adds on the int8 tensor cores (the work model of
``bench_torch/roofline``). The median of that bound per step, over the
median device time of the program span ``itx.render.compose`` (an event
pair around K2's chunked launches). None without the span's device
interval (a CPU run, or a program without the span)."""

from bench_torch.metrics._uhd import share


def read(ctx):
    return share(ctx, "itx.render.compose", "compose_bytes", "macs")
