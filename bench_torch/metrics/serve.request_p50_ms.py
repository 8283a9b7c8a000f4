"""serve.request_p50_ms: read by the serve driver over the window's requests (see drivers/serve.py)."""


def read(ctx):
    return ctx.counters.get("request_p50_ms")
