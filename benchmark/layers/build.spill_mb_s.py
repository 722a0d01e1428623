"""build.spill_mb_s: the streamed build's spill pass as a rate, MB a
second: the bytes it appended to the bucket files (the program's counter
"build.spill_bytes") over the pass's seconds (phase_times["spill"]), over
the builds of the traced window."""


def read(ctx: dict):
    try:
        from point_cloud_viewer_tpu_torch.utils.progress import span_totals
    except ImportError:  # a program without the span table
        return None
    written = span_totals().get("build.spill_bytes")
    phases = ctx.get("phases", [])[:ctx.get("traced_units")]
    seconds = sum(p.get("spill", 0.0) for p in phases)
    if written is None or not written[0] or seconds <= 0:
        return None
    return written[0] / 1e6 / seconds
