"""build.bucket_device_busy_s: the streamed build's buckets on the card's
clock, from the event recorded before each bucket's upload to the one
after its last launch on the pipeline's stream (the card's work and the
host's launching of it), summed over a build's buckets, seconds, mean a build
of the window (the program's phase_times["bucket_device_busy"])."""


def read(ctx: dict):
    seconds = [p["bucket_device_busy"] for p in ctx.get("phases", [])
               if "bucket_device_busy" in p]
    return sum(seconds) / len(seconds) if seconds else None
