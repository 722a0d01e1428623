"""select.fetch_kb_per_frame: the bytes the cull session copies back to
the host (the program's counter "select.fetch_bytes"), kB (10^3 B) a frame
of the traced window."""


def read(ctx: dict):
    try:
        from point_cloud_viewer_tpu_torch.utils.progress import span_totals
    except ImportError:  # a program without the span table
        return None
    entry = span_totals().get("select.fetch_bytes")
    if entry is None or not ctx.get("traced_units"):
        return None
    return entry[0] / 1e3 / ctx["traced_units"]
