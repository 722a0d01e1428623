"""select.ids_ms: the frame's capped NodeId list (the program's span
"select.ids", viewer.render_loop.node_id_list), ms a frame of the traced
window (host clock)."""


def read(ctx: dict):
    try:
        from point_cloud_viewer_tpu_torch.utils.progress import span_totals
    except ImportError:  # a program without the span table
        return None
    entry = span_totals().get("select.ids")
    if entry is None or not ctx.get("traced_units"):
        return None
    return 1e3 * entry[1] / ctx["traced_units"]
