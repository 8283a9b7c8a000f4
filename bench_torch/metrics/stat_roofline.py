"""stat_roofline: the run statistic's share of its roofline, in percent.

One read of each canvas's crop and its float out, over the device time of
the ops launched inside the harness's ``stat`` span (around the program's
call of ``packed_luma``)."""

from bench_torch import roofline
from bench_torch.metrics._share import span_device_s, work


def read(ctx):
    dev_s, w = span_device_s(ctx, "stat"), work(ctx)
    if dev_s is None or w is None:
        return None
    bound = roofline.bound_seconds(w[2], 0, ctx.device_name)
    return None if bound is None else 100.0 * bound / dev_s
