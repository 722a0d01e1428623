"""query.select_nodes_ms: node selection, the job list that
PointCloudClient.stream builds on the caller's thread before any worker
starts (the program's span "query.select_nodes"), ms a query over the
queries of the traced window (host clock)."""


def read(ctx: dict):
    try:
        from point_cloud_viewer_tpu_torch.utils.progress import span_totals
    except ImportError:  # a program without the span table
        return None
    entry = span_totals().get("query.select_nodes")
    if entry is None or not ctx.get("traced_units"):
        return None
    return 1e3 * entry[1] / ctx["traced_units"]
