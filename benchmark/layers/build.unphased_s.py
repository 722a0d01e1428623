"""build.unphased_s: the command's wall time that none of the in-core
path's five top-level phases covers (the program's phase_times["total"],
cli.build_octree.main from entry to return, less the phases named below),
seconds, mean a build of the window (host clock)."""

PHASES = ("read ply", "quantize+morton", "device core", "group levels",
          "encode+write")


def read(ctx: dict):
    seconds = [p["total"] - sum(p.get(k, 0.0) for k in PHASES)
               for p in ctx.get("phases", []) if "total" in p]
    return sum(seconds) / len(seconds) if seconds else None
