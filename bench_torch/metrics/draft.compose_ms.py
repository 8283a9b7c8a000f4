"""draft.compose_ms: median of the harness's ``compose`` spans over the window's drafts."""

from bench_torch.harness import median


def read(ctx):
    spans = ctx.counters.get("spans")
    return median(spans.durations_ms("compose")) if spans else None
