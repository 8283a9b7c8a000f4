"""step.stat_device_ms: median device time of the run statistic in one batched
step, in ms.

Read from the program's span ``itx.stat``; None where the program has no spans
or the span has no device interval (a CPU run)."""


def read(ctx):
    try:
        from image_transformation_tpu_torch.core.timing import span_summary
    except ImportError:
        return None
    entry = span_summary()["spans"].get("itx.stat")
    return None if entry is None else entry["device_ms_p50"]
