"""Helpers of the campaign cell's metric readers (not a metric)."""

from bench_torch import roofline
from bench_torch.metrics._uhd import work_split


def span_device_ms_sum(name):
    """(summed device ms, spans closed) of the program span ``name``, or
    None (no spans, no device interval, no sums: a CPU run, or a program
    without the span or its sums)."""
    try:
        from image_transformation_tpu_torch.core.timing import span_summary
    except ImportError:
        return None
    entry = span_summary()["spans"].get(name)
    if entry is None or entry.get("device_ms_sum") is None:
        return None
    return entry["device_ms_sum"], entry["count"]


def summed_share(ctx, span, bytes_key, macs_key=None):
    """Percent: the window's summed bound of ``bytes_key`` (and the
    multiply-adds of ``macs_key``) over the summed device time of ``span``.
    The cell's steps differ by ratio, so sums, not medians; None unless
    the span was kept once for each step of the window."""
    got, w = span_device_ms_sum(span), work_split(ctx)
    if not got or not w or not w[bytes_key] or got[1] != len(w[bytes_key]) or got[0] <= 0:
        return None
    macs = w[macs_key] if macs_key else [0] * len(w[bytes_key])
    bounds = [roofline.bound_seconds(b, m, ctx.device_name) for b, m in zip(w[bytes_key], macs)]
    if any(b is None for b in bounds):
        return None
    return 100.0 * sum(bounds) / (got[0] / 1e3)
