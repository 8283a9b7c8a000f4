"""campaign.compose_roofline: the upscaling compose's share of its roofline,
in percent, on per-canvas sources.

K2 resamples and blends each step's placements, each canvas from its own
creative's cutouts: 8 bytes a changed pixel (read and written), each
canvas's own placed cutouts read once (4 bytes a live pixel), and the exact
two-pass resample's multiply-adds on the int8 tensor cores (the work model
of ``bench_torch/roofline``). The window's summed bound over the summed
device time of the program span ``itx.render.compose`` (an event pair
around K2's chunked launches). None without the span's summed device
interval (a CPU run, or a program without the span or its sums)."""

from bench_torch.metrics._campaign import summed_share


def read(ctx):
    return summed_share(ctx, "itx.render.compose", "compose_bytes", "macs")
