"""build.device_core_s: the tree derivation on the card (upload, sort, K6,
K4, K1, extras, fetch), seconds, mean a build of the window (the program's
phase_times["device core"], host clock; the core ends in a fetch, so the
card has finished)."""


def read(ctx: dict):
    seconds = [p["device core"] for p in ctx.get("phases", [])
               if "device core" in p]
    return sum(seconds) / len(seconds) if seconds else None
