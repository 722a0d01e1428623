"""select.k5_roofline: K5, the cull kernel (csrc/cull.cu), as a share of its
roofline, one frame a launch: the least time of the work every frame needs
at the node table's K (the table read once, 20 B a node: f32 min corner,
f32 edge, i32 count; the 4 x 4 f32 matrix; 9 B a node written: size,
visibility, priority; 166 f32 operations a node for its corners' screen
box and the test's set-up, chip_smoke.py's CULL_NODE_OPS, leaving out the
data-dependent axis tests) over its kernel's device time a launch, from the
trace."""

from measure import kernel_seconds_per_launch, roofline_share

NODE_BYTES_IN = 12 + 4 + 4
NODE_BYTES_OUT = 4 + 1 + 4
MATRIX_BYTES = 64
NODE_OPS = 7 + 157 + 2


def read(ctx: dict):
    seconds = kernel_seconds_per_launch(ctx["trace"]["kernels"],
                                        ("cull_kernel",), "cull_kernel")
    if seconds is None:
        return None
    k = ctx["nodes"]
    return roofline_share(k * (NODE_BYTES_IN + NODE_BYTES_OUT) + MATRIX_BYTES,
                          NODE_OPS * k, seconds)
