"""campaign.restore_roofline: the restore's share of its roofline, in percent,
where each canvas restores from its own gradient line.

K3's ramp form with a line per canvas writes back the pixels the previous
step of the same ratio changed: 4 bytes a pixel (the work model of
``bench_torch/roofline``). The window's summed bound over the summed device
time of the program span ``itx.render.restore`` (an event pair around K3's
launch). None without the span's summed device interval (a CPU run, or a
program without the span or its sums)."""

from bench_torch.metrics._campaign import summed_share


def read(ctx):
    return summed_share(ctx, "itx.render.restore", "restore_bytes")
