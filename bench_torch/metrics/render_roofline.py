"""render_roofline: the reuse render's share of its roofline, in percent.

The least time the card could take for the window's renders (the bytes and
the resample's multiply-adds the results require, from the copied work
model) over the device time of every op launched inside the harness's
``step`` span except those of the statistic's span."""

from bench_torch import roofline
from bench_torch.metrics._share import span_device_s, work


def read(ctx):
    dev_s, w = span_device_s(ctx, "step"), work(ctx)
    if dev_s is None or w is None:
        return None
    bound = roofline.bound_seconds(w[0], w[1], ctx.device_name)
    return None if bound is None else 100.0 * bound / dev_s
