"""query.ms_p50: the median query of the window, ms (host clock, issue to
the last batch drained)."""

from measure import percentile


def read(ctx: dict):
    return percentile(ctx["ms"], 50) if ctx.get("ms") else None
