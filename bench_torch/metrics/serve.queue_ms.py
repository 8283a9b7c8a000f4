"""serve.queue_ms: read by the serve driver over the window's requests (see drivers/serve.py)."""


def read(ctx):
    return ctx.counters.get("queue_ms")
