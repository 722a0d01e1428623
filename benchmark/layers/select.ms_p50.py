"""select.ms_p50: the median frame of the window, ms (host clock, camera
matrix to the capped node-id list)."""

from measure import percentile


def read(ctx: dict):
    return percentile(ctx["ms"], 50) if ctx.get("ms") else None
