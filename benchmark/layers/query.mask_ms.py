"""query.mask_ms: the workers' filter_batch, the card's mask and the host
refinement (the program's span "query.mask"), thread-ms summed over the
worker threads, a query of the traced window (host clock)."""


def read(ctx: dict):
    try:
        from point_cloud_viewer_tpu_torch.utils.progress import span_totals
    except ImportError:  # a program without the span table
        return None
    entry = span_totals().get("query.mask")
    if entry is None or not ctx.get("traced_units"):
        return None
    return 1e3 * entry[1] / ctx["traced_units"]
