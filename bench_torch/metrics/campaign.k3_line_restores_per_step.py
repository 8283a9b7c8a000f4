"""campaign.k3_line_restores_per_step: K3 launches with a gradient line per
canvas, per step; 1.0 where every step of the window restored in that form.

Read from the program's counter ``LAUNCHES["restore_windows_lines"]``
around the window, over the window's steps; None on a CPU run (no
launches) or where the program has no such counter."""


def read(ctx):
    lines, steps = ctx.counters.get("k3_line_restores"), ctx.counters.get("steps")
    if lines is None or not steps:
        return None
    return lines / steps
