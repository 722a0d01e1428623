"""build.k4_roofline: K4, the promotion stage (csrc/promote.cu), as a share
of its roofline: the least time of its work (3 B an element: the u8 level
bounds and leaf levels read, the u8 final levels written, at the card's
peak bandwidth) over its kernel's device time a launch, from the trace."""

from measure import kernel_seconds_per_launch, roofline_share

BYTES_PER_POINT = 3


def read(ctx: dict):
    seconds = kernel_seconds_per_launch(ctx["trace"]["kernels"],
                                        ("promote_levels",), "promote_levels")
    if seconds is None:
        return None
    return roofline_share(BYTES_PER_POINT * ctx["points_per_build"], 0.0,
                          seconds)
