"""select.fetch_ms: the step's three copies back to the host, which wait for
the card (the program's span "select.fetch"), ms a frame of the traced
window (host clock)."""


def read(ctx: dict):
    try:
        from point_cloud_viewer_tpu_torch.utils.progress import span_totals
    except ImportError:  # a program without the span table
        return None
    entry = span_totals().get("select.fetch")
    if entry is None or not ctx.get("traced_units"):
        return None
    return 1e3 * entry[1] / ctx["traced_units"]
