"""build.read_ply_s: the PLY read's seconds, mean a build of the window
(the program's phase_times["read ply"], host clock)."""


def read(ctx: dict):
    seconds = [p["read ply"] for p in ctx.get("phases", []) if "read ply" in p]
    return sum(seconds) / len(seconds) if seconds else None
