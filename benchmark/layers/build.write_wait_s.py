"""build.write_wait_s: the main thread blocked on the write pool's futures
inside encode+write, seconds, mean a build of the window (the program's
phase_times["encode+write/wait"], host clock)."""


def read(ctx: dict):
    seconds = [p["encode+write/wait"] for p in ctx.get("phases", [])
               if "encode+write/wait" in p]
    return sum(seconds) / len(seconds) if seconds else None
