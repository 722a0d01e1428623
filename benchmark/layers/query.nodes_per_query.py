"""query.nodes_per_query: nodes selected for decoding (the program's counter
"query.nodes"), a query of the traced window."""


def read(ctx: dict):
    try:
        from point_cloud_viewer_tpu_torch.utils.progress import span_totals
    except ImportError:  # a program without the span table
        return None
    entry = span_totals().get("query.nodes")
    if entry is None or not ctx.get("traced_units"):
        return None
    return entry[0] / ctx["traced_units"]
