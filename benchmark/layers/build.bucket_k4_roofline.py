"""build.bucket_k4_roofline: K4, the promotion stage (csrc/promote.cu), as
a share of its roofline where a launch promotes one bucket of the streamed
build: the least time of its work (3 B a point, as build.k4_roofline
counts it, over a bucket's points, as build.bucket_k6_roofline takes them)
over its kernel's device time a launch, from the trace."""

import harness
from measure import kernel_seconds_per_launch, roofline_share

BYTES_PER_POINT = 3


def read(ctx: dict):
    points = harness.load_module(
        "layers", "build.bucket_k6_roofline").points_per_launch(ctx)
    seconds = kernel_seconds_per_launch(ctx["trace"]["kernels"],
                                        ("promote_levels",), "promote_levels")
    if points is None or seconds is None:
        return None
    return roofline_share(BYTES_PER_POINT * points, 0.0, seconds)
