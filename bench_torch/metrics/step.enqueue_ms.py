"""step.enqueue_ms: median host time of one batched step, in ms: what the host
takes to enqueue it.

Read from the program's span ``itx.step``; None where the program has no spans
or the span has no records."""


def read(ctx):
    try:
        from image_transformation_tpu_torch.core.timing import span_summary
    except ImportError:
        return None
    entry = span_summary()["spans"].get("itx.step")
    return None if entry is None else entry["host_ms_p50"]
