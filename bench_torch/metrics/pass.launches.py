"""pass.launches: device operations launched inside the harness's ``pass``
span (the multi-ratio step: device solve, meta, plane, K2, luma), per pass."""


def read(ctx):
    t, passes = ctx.trace_summary, ctx.counters.get("passes")
    if not t or not passes:
        return None
    n = t["spans"].get("pass", {}).get("launches")
    return n / passes if n else None
