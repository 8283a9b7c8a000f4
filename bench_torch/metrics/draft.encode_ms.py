"""draft.encode_ms: median of the harness's ``encode`` spans over the window's drafts."""

from bench_torch.harness import median


def read(ctx):
    spans = ctx.counters.get("spans")
    return median(spans.durations_ms("encode")) if spans else None
