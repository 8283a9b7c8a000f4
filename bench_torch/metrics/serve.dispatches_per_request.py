"""serve.dispatches_per_request: read by the serve driver over the window's requests (see drivers/serve.py)."""


def read(ctx):
    return ctx.counters.get("dispatches_per_request")
