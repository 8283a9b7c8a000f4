"""step.render_device_ms: median device time of one batched step's render (meta,
K3 and K2), in ms.

Read from the program's span ``itx.render``; None where the program has no
spans or the span has no device interval (a CPU run)."""


def read(ctx):
    try:
        from image_transformation_tpu_torch.core.timing import span_summary
    except ImportError:
        return None
    entry = span_summary()["spans"].get("itx.render")
    return None if entry is None else entry["device_ms_p50"]
