"""Helpers of the UHD cell's metric readers (not a metric)."""

import statistics

from bench_torch import roofline


def work_split(ctx):
    """The ``score_up`` driver's per-step work of the window (computed once)."""
    if "work_split_done" not in ctx.counters and "work_split" in ctx.counters:
        ctx.counters["work_split_done"] = ctx.counters["work_split"]()
    return ctx.counters.get("work_split_done")


def span_device_ms(name):
    """Median device ms of the program span ``name``, or None (no spans, no
    device interval: a CPU run, or a program without the span)."""
    try:
        from image_transformation_tpu_torch.core.timing import span_summary
    except ImportError:
        return None
    entry = span_summary()["spans"].get(name)
    return None if entry is None else entry["device_ms_p50"]


def share(ctx, span, bytes_key, macs_key=None):
    """Percent: the median per-step bound of ``bytes_key`` (and the
    multiply-adds of ``macs_key``) over the median device time of ``span``."""
    dev_ms, w = span_device_ms(span), work_split(ctx)
    if not dev_ms or not w or not w[bytes_key]:
        return None
    macs = w[macs_key] if macs_key else [0] * len(w[bytes_key])
    bounds = [roofline.bound_seconds(b, m, ctx.device_name) for b, m in zip(w[bytes_key], macs)]
    if any(b is None for b in bounds):
        return None
    return 100.0 * statistics.median(bounds) / (dev_ms / 1e3)
