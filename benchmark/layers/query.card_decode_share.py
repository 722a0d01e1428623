"""query.card_decode_share: the share of the query client's nodes whose
positions the card alone decoded (the program's counters
"query.decode.card" and "query.decode.host"), over the traced window, as a
fraction; nothing on a program without the counters."""


def read(ctx: dict):
    try:
        from point_cloud_viewer_tpu_torch.utils.progress import span_totals
    except ImportError:  # a program without the span table
        return None
    totals = span_totals()
    card = totals.get("query.decode.card", [0])[0]
    host = totals.get("query.decode.host", [0])[0]
    if card + host == 0:
        return None
    return card / (card + host)
