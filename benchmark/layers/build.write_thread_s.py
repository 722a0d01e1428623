"""build.write_thread_s: the write pool's node-file writes, thread-seconds
summed over its threads, mean a build of the window (the program's
phase_times["encode+write/write"], host clock)."""


def read(ctx: dict):
    seconds = [p["encode+write/write"] for p in ctx.get("phases", [])
               if "encode+write/write" in p]
    return sum(seconds) / len(seconds) if seconds else None
