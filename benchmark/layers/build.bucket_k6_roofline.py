"""build.bucket_k6_roofline: K6, the leaf stage (csrc/leaf_levels.cu), as a
share of its roofline where a launch derives one bucket of the streamed
build: the least time of its work (10 B a point, as build.k6_roofline
counts it, over a bucket's points: the traced builds' uploaded codes, 8 B
a point, over their derived buckets) over the device time of its three
kernels a launch, from the trace."""

from measure import kernel_seconds_per_launch, roofline_share

KERNELS = ("leaf_bounds", "leaf_carry_scan", "leaf_assign")
BYTES_PER_POINT = 10


def points_per_launch(ctx: dict):
    """Points a derived bucket holds, over the traced builds' phases."""
    phases = ctx.get("phases", [])[:ctx.get("traced_units")]
    buckets = sum(p.get("buckets_derived", 0) for p in phases)
    if not buckets:
        return None
    return sum(p.get("bucket_upload_bytes", 0) for p in phases) / 8 / buckets


def read(ctx: dict):
    points = points_per_launch(ctx)
    seconds = kernel_seconds_per_launch(ctx["trace"]["kernels"], KERNELS,
                                        "leaf_bounds")
    if points is None or seconds is None:
        return None
    return roofline_share(BYTES_PER_POINT * points, 0.0, seconds)
