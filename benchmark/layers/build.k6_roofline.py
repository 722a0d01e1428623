"""build.k6_roofline: K6, the leaf stage (csrc/leaf_levels.cu), as a share
of its roofline: the least time of its work (10 B an element: the int64
codes read, the u8 level bounds and u8 leaf levels written, at the card's
peak bandwidth) over the device time of its three kernels a launch, from
the trace."""

from measure import kernel_seconds_per_launch, roofline_share

KERNELS = ("leaf_bounds", "leaf_carry_scan", "leaf_assign")
BYTES_PER_POINT = 10


def read(ctx: dict):
    seconds = kernel_seconds_per_launch(ctx["trace"]["kernels"], KERNELS,
                                        "leaf_bounds")
    if seconds is None:
        return None
    return roofline_share(BYTES_PER_POINT * ctx["points_per_build"], 0.0,
                          seconds)
