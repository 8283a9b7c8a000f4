"""Percent of the traced window in which the device ran no operation (profiler)."""

from bench_torch.metrics._share import idle_share


def read(ctx):
    return idle_share(ctx)
