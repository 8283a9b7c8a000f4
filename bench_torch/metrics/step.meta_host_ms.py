"""step.meta_host_ms: median host time of one batched step's meta building (the
restore's and K2's meta tensors), in ms.

Read from the program's span ``itx.render.meta``; None where the program has no
spans or the span has no records."""


def read(ctx):
    try:
        from image_transformation_tpu_torch.core.timing import span_summary
    except ImportError:
        return None
    entry = span_summary()["spans"].get("itx.render.meta")
    return None if entry is None else entry["host_ms_p50"]
