"""build.points_per_bucket: the points a non-empty bucket of the streamed
build holds when loaded back from the spill (the program's counters
"build.bucket_points" over "build.buckets", over the builds of the traced
window)."""


def read(ctx: dict):
    try:
        from point_cloud_viewer_tpu_torch.utils.progress import span_totals
    except ImportError:  # a program without the span table
        return None
    totals = span_totals()
    points, buckets = totals.get("build.bucket_points"), totals.get(
        "build.buckets")
    if points is None or not buckets or not buckets[0]:
        return None
    return points[0] / buckets[0]
