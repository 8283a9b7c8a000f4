"""Helpers of the metric readers (not a metric)."""


def span_device_s(ctx, span):
    """Device seconds of the ops launched inside the harness span ``span``, or None."""
    t = ctx.trace_summary
    if not t:
        return None
    s = t["spans"].get(span, {}).get("device_s")
    return s if s else None


def idle_share(ctx):
    """Percent of the traced window in which no device operation ran."""
    t = ctx.trace_summary
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def work(ctx):
    """The score driver's work model of the window (computed once)."""
    if "work_done" not in ctx.counters and "work" in ctx.counters:
        ctx.counters["work_done"] = ctx.counters["work"]()
    return ctx.counters.get("work_done")
