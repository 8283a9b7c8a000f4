"""uhd.k2_chunks_per_step: K2 launches per step, one per chunk of canvases
whose scratch fits K2's budget.

Read from the program's counter ``LAUNCHES["fused_v3_chunks"]`` around the
window, over the window's steps; None on a CPU run (no launches) or where
the program has no such counter."""


def read(ctx):
    chunks, steps = ctx.counters.get("k2_chunks"), ctx.counters.get("steps")
    if chunks is None or not steps:
        return None
    return chunks / steps
