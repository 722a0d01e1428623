"""build.top_s: the streamed build's shallow top, levels up to the bucket
level built on the host from the buckets' residuals and written, seconds,
mean a build of the window (the program's phase_times["top"], host
clock)."""


def read(ctx: dict):
    seconds = [p["top"] for p in ctx.get("phases", []) if "top" in p]
    return sum(seconds) / len(seconds) if seconds else None
