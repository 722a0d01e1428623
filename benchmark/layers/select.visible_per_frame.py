"""select.visible_per_frame: the nodes a frame sees before the cap (the
program's counter "select.visible", DeviceCullSession.step_capped), the
mean over the frames of the traced window."""


def read(ctx: dict):
    try:
        from point_cloud_viewer_tpu_torch.utils.progress import span_totals
    except ImportError:  # a program without the span table
        return None
    entry = span_totals().get("select.visible")
    if entry is None or not ctx.get("traced_units"):
        return None
    return entry[0] / ctx["traced_units"]
