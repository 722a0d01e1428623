"""build.bucket_load_s: the streamed build's reads of its split buckets back
from the spill files, seconds, mean a build of the window (the program's
phase_times["bucket_load"], host clock)."""


def read(ctx: dict):
    seconds = [p["bucket_load"] for p in ctx.get("phases", [])
               if "bucket_load" in p]
    return sum(seconds) / len(seconds) if seconds else None
