"""build.spill_s: the streamed build's PASS 2, the input read again,
Morton-encoded and appended to the bucket spill files, seconds, mean a
build of the window (the program's phase_times["spill"], host clock)."""


def read(ctx: dict):
    seconds = [p["spill"] for p in ctx.get("phases", []) if "spill" in p]
    return sum(seconds) / len(seconds) if seconds else None
