"""uhd.restore_roofline: the gradient restore's share of its roofline, in percent.

K3's ramp form writes the previous step's changed pixels back to the
gradient: 4 bytes a pixel changed by the previous step (the work model of
``bench_torch/roofline``). The median of that bound per step, over the
median device time of the program span ``itx.render.restore`` (an event
pair around K3's launch). None without the span's device interval (a CPU
run, or a program without the span)."""

from bench_torch.metrics._uhd import share


def read(ctx):
    return share(ctx, "itx.render.restore", "restore_bytes")
