"""build.encode_s: the main thread's gather and fixpoint encode of the node
files (native gather_encode and take_rows, or their numpy fallbacks) inside
encode+write, seconds, mean a build of the window (the program's
phase_times["encode+write/encode"], host clock)."""


def read(ctx: dict):
    seconds = [p["encode+write/encode"] for p in ctx.get("phases", [])
               if "encode+write/encode" in p]
    return sum(seconds) / len(seconds) if seconds else None
