"""query.decode_ms: the workers' node decode (points_in_node, the program's
span "query.decode"), thread-ms summed over the worker threads, a query of
the traced window (host clock)."""


def read(ctx: dict):
    try:
        from point_cloud_viewer_tpu_torch.utils.progress import span_totals
    except ImportError:  # a program without the span table
        return None
    entry = span_totals().get("query.decode")
    if entry is None or not ctx.get("traced_units"):
        return None
    return 1e3 * entry[1] / ctx["traced_units"]
