"""build.bucket_write_s: the streamed build's encode and write of its bucket
subtrees' node files (the write pool of each bucket), seconds summed over
the buckets, mean a build of the window (the program's
phase_times["bucket_encode_write"], host clock)."""


def read(ctx: dict):
    seconds = [p["bucket_encode_write"] for p in ctx.get("phases", [])
               if "bucket_encode_write" in p]
    return sum(seconds) / len(seconds) if seconds else None
