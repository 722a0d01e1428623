"""query.launches_per_query: kernels and memsets the card ran in the traced
window, over the queries served in it."""


def read(ctx: dict):
    trace = ctx["trace"]
    if not ctx.get("traced_units"):
        return None
    kernels = sum(n for n, _ in trace["kernels"].values())
    return (kernels + trace["memsets"]) / ctx["traced_units"]
