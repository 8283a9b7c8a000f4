"""step.host_ms: median host time to enqueue one batched step (harness span ``step``)."""


def read(ctx):
    return ctx.counters.get("step_host_ms")
