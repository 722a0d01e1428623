"""CLI: stream a query over point clouds and print stats — the smoke-test
client (port of point_cloud_viewer_tpu/cli/query_points.py; reference:
point_cloud_client/src/bin/test.rs).

Usage: python -m point_cloud_viewer_tpu_torch.cli.query_points DIR [DIR ...] \
           [--aabb X0,Y0,Z0,X1,Y1,Z1 | --cell_union TOKENS |
            --web_mercator_rect MINX,MINY,MAXX,MAXY,Z] \
           [--filter_interval ATTR=LO,HI] [--device cuda] [--no-device_filter]

The per-point filter runs on --device (--device_filter, the default) or on
the host (--no-device_filter); both give the same points.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("locations", nargs="+", help="Point cloud directories.")
    parser.add_argument("--attributes", nargs="*", default=["color"])
    parser.add_argument(
        "--aabb", default=None, metavar="X0,Y0,Z0,X1,Y1,Z1",
        help="Restrict to an axis-aligned box.",
    )
    parser.add_argument(
        "--cell_union", default=None, metavar="TOKEN,TOKEN,...",
        help="Restrict to an S2 cell union (hex cell tokens). Runs on "
             "--device with --device_filter (trig-free point->cell-id).",
    )
    parser.add_argument(
        "--web_mercator_rect", default=None, metavar="MINX,MINY,MAXX,MAXY,Z",
        help="Restrict to a Web-Mercator map rectangle given in zoomed "
             "tile-pixel coordinates at zoom level Z. With --device_filter "
             "the containment test runs on --device (hybrid exact: "
             "calibrated margin + host boundary refinement, bit-equal to "
             "host).",
    )
    parser.add_argument(
        "--filter_interval", action="append", default=[], metavar="ATTR=LO,HI"
    )
    parser.add_argument("--num_points", type=int, default=None,
                        help="Stop after this many points.")
    parser.add_argument("--batch_size", type=int, default=500_000)
    parser.add_argument("--num_threads", type=int, default=None)
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
    args = parser.parse_args(argv)

    from ..math.intervals import ClosedInterval
    from ..query.client import PointCloudClient
    from ..query.point_query import PointQuery
    from ..query.location import AllPoints

    location = AllPoints()
    if sum(map(bool, [args.aabb, args.cell_union, args.web_mercator_rect])) > 1:
        parser.error("--aabb, --cell_union and --web_mercator_rect are "
                     "mutually exclusive")
    if args.aabb:
        from ..utils.progress import parse_aabb

        try:
            location = parse_aabb(args.aabb)
        except ValueError as e:
            parser.error(str(e))
    elif args.web_mercator_rect:
        from ..math.web_mercator import WebMercatorRect

        v = args.web_mercator_rect.split(",")
        rect = WebMercatorRect.from_zoomed_coordinates(
            [float(v[0]), float(v[1])], [float(v[2]), float(v[3])], int(v[4])
        )
        if rect is None:
            parser.error("invalid --web_mercator_rect (out of range for zoom)")
        location = rect
    elif args.cell_union:
        from ..math.s2 import token_to_id
        from ..s2_cells.cell_union import CellUnion

        location = CellUnion(
            [token_to_id(t) for t in args.cell_union.split(",") if t]
        )
    intervals = {}
    for kv in args.filter_interval:
        k, s = kv.split("=", 1)
        intervals[k] = ClosedInterval.from_str(s)

    client = PointCloudClient.from_locations(
        args.locations, batch_size=args.batch_size,
        num_threads=args.num_threads, device_filter=args.device_filter,
        device=args.device,
    )
    total = [0]
    start = time.perf_counter()

    class Done(Exception):
        pass

    def cb(batch):
        total[0] += len(batch)
        if args.num_points is not None and total[0] >= args.num_points:
            raise Done()

    try:
        client.for_each_point_data(
            PointQuery(
                attributes=args.attributes,
                location=location,
                filter_intervals=intervals,
            ),
            cb,
        )
    except Done:
        pass
    elapsed = time.perf_counter() - start
    rate = total[0] / elapsed / 1e6 if elapsed > 0 else 0.0
    print(f"Streamed {total[0]} points in {elapsed:.3f}s ({rate:.2f} Mpoints/s).")
    return 0


if __name__ == "__main__":
    sys.exit(main())
