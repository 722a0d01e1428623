"""build.encode_write_s: the node files' encoding and writing, seconds, mean
a build of the window (the program's phase_times["encode+write"], host
clock)."""


def read(ctx: dict):
    seconds = [p["encode+write"] for p in ctx.get("phases", [])
               if "encode+write" in p]
    return sum(seconds) / len(seconds) if seconds else None
