"""query.fused_share: the share of the nodes masked on the card whose mask
ran through the one-kernel route (the program's counters
"query.mask.fused" and "query.mask.eager"), over the traced window, as a
fraction; nothing on a program without the counters."""


def read(ctx: dict):
    try:
        from point_cloud_viewer_tpu_torch.utils.progress import span_totals
    except ImportError:  # a program without the span table
        return None
    totals = span_totals()
    fused = totals.get("query.mask.fused", [0])[0]
    eager = totals.get("query.mask.eager", [0])[0]
    if fused + eager == 0:
        return None
    return fused / (fused + eager)
