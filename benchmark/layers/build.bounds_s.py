"""build.bounds_s: the streamed build's PASS 1, the bounding pass that reads
the whole input for its box, seconds, mean a build of the window (the
program's phase_times["bounds"], host clock)."""


def read(ctx: dict):
    seconds = [p["bounds"] for p in ctx.get("phases", []) if "bounds" in p]
    return sum(seconds) / len(seconds) if seconds else None
