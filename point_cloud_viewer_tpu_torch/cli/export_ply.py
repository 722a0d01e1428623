"""CLI: stream a query out of point clouds into a PLY file (incremental
writing with the vertex count patched on close).

Copy of point_cloud_viewer_tpu/cli/export_ply.py:1-60, with one
difference: the route flags of cli/query_points.py, so the per-point
filter runs on --device (cuda by default; without a card it raises) or,
with --no-device_filter, on the host.  Both routes export the same
points.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("locations", nargs="+", help="Point cloud directories.")
    parser.add_argument("--output", required=True, help="Output PLY path.")
    parser.add_argument("--attributes", nargs="*", default=["color"])
    parser.add_argument(
        "--aabb", default=None, metavar="X0,Y0,Z0,X1,Y1,Z1",
        help="Restrict to an axis-aligned box.",
    )
    parser.add_argument(
        "--filter_interval", action="append", default=[], metavar="ATTR=LO,HI"
    )
    parser.add_argument("--append", action="store_true")
    # Route flags of cli/query_points.py (the one difference).
    parser.add_argument(
        "--device_filter", action=argparse.BooleanOptionalAction,
        default=True,
        help="Run per-point geometry/interval filtering in f64 on --device "
             "(the default; bit-equal to host); --no-device_filter filters "
             "on the host.",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="PyTorch device of the filter: cuda (default) or cpu (unused "
             "with --no-device_filter).",
    )
    # End of the route flags.
    args = parser.parse_args(argv)

    from ..io.ply import PlyStreamWriter
    from ..math.intervals import ClosedInterval
    from ..query.client import PointCloudClient
    from ..query.location import AllPoints
    from ..query.point_query import PointQuery

    location = AllPoints()
    if args.aabb:
        from ..utils.progress import parse_aabb

        try:
            location = parse_aabb(args.aabb)
        except ValueError as e:
            parser.error(str(e))
    intervals = {}
    for kv in args.filter_interval:
        k, s = kv.split("=", 1)
        intervals[k] = ClosedInterval.from_str(s)

    client = PointCloudClient.from_locations(
        args.locations, device_filter=args.device_filter, device=args.device
    )
    with PlyStreamWriter(args.output, append=args.append) as writer:
        client.for_each_point_data(
            PointQuery(
                attributes=args.attributes,
                location=location,
                filter_intervals=intervals,
            ),
            writer.write,
        )
        count = writer.count
    print(f"Wrote {count} points to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
