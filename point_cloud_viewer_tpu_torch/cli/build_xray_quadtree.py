"""CLI: build an X-ray quadtree from point clouds (port of
point_cloud_viewer_tpu/cli/build_xray_quadtree.py; reference:
xray/src/build_quadtree.rs:22-221).

Usage: python -m point_cloud_viewer_tpu_torch.cli.build_xray_quadtree \
           --output_directory DIR --coloring_strategy xray LOCATIONS... \
           [--device cuda|cpu] [--no-use_device] [--no-device_filter]

The port's defaults run on the card: each tile's splat reduction on
--device (--use_device) and the query client's per-point filter on
--device (--device_filter).  The JAX package's CLI defaults to the host
for both.  Without a card, and without --device cpu, this CLI raises;
--no-use_device --no-device_filter is the host (numpy) route.
"""

from __future__ import annotations

import argparse
import sys

from ..utils.progress import parse_key_val


def _parse_color(s: str):
    parts = [int(v) for v in s.split(",")]
    if len(parts) == 3:
        parts.append(255)
    if len(parts) != 4:
        raise argparse.ArgumentTypeError("color must be R,G,B[,A]")
    return tuple(parts)


def main(argv=None, stats=None) -> int:
    """`stats`: when given, build_xray_quadtree fills it (leaf tiles,
    tiles, points splatted, walls of the leaf and pyramid passes)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("locations", nargs="+", help="Point cloud directories.")
    parser.add_argument("--output_directory", required=True)
    parser.add_argument(
        "--resolution", type=float, default=0.01,
        help="Size of 1 pixel in meters at the deepest level.",
    )
    parser.add_argument(
        "--tile_size", type=int, default=256, help="Tile size in pixels (power of two)."
    )
    parser.add_argument(
        "--coloring_strategy",
        choices=["xray", "colored", "colored_with_intensity", "colored_with_height_stddev"],
        default="xray",
    )
    parser.add_argument("--min_intensity", type=float, default=1.0)
    parser.add_argument("--max_intensity", type=float, default=1.0e5)
    parser.add_argument("--max_stddev", type=float, default=1.0)
    parser.add_argument(
        "--colormap", choices=["jet", "purplish"], default="jet",
        help="Value->color map for colored_with_height_stddev "
        "(reference build_quadtree.rs:67-72).",
    )
    parser.add_argument(
        "--tile_background_color", type=_parse_color, default=(255, 255, 255, 255)
    )
    parser.add_argument(
        "--filter_interval", action="append", type=parse_key_val, default=[],
        metavar="ATTR=LO,HI", help="Keep only points whose attribute is in [LO, HI].",
    )
    parser.add_argument(
        "--binning", type=parse_key_val, default=None, metavar="ATTR=SIZE",
        help="Bin by an attribute before averaging (e.g. timestamp=10).",
    )
    parser.add_argument(
        "--root_node_id", default="r",
        help="Build only the subtree under this node (for sharded builds).",
    )
    parser.add_argument("--num_threads", type=int, default=None,
                        help="Tile pool size (default: min(8, cpu count), at least 2).")
    parser.add_argument(
        "--use_device", action=argparse.BooleanOptionalAction, default=True,
        help="Run each tile's splat reduction as torch ops on --device (the "
             "port's default; bit-identical to the host reductions under "
             "their exactness condition, full-f64 heights within 1 LSB); "
             "--no-use_device splats on the host. The JAX CLI splats on "
             "the host unless asked.",
    )
    parser.add_argument(
        "--device_filter", action=argparse.BooleanOptionalAction,
        default=True,
        help="Run the query client's per-point filter in f64 on --device "
             "(the port's default; bit-equal to host); --no-device_filter "
             "filters on the host, the JAX CLI's default.",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="PyTorch device of the splat and the filter: cuda (default; "
             "raises without a card) or cpu.",
    )
    parser.add_argument(
        "--extension", default=None, metavar="pkg.mod:attr",
        help="Plugin adding flags and/or a query_from_global transform "
             "(the reference's Extension trait analogue).",
    )
    # Two-phase parse so the extension can add its own flags.
    pre, _ = parser.parse_known_args(argv)
    from ..utils.extension import apply_hook, load_extension

    extension = load_extension(pre.extension)
    apply_hook(extension, "add_arguments", parser)
    args = parser.parse_args(argv)

    if args.tile_size <= 0 or args.tile_size & (args.tile_size - 1):
        parser.error("tile_size must be a power of two")

    from ..device import resolve_device
    from ..math.intervals import ClosedInterval
    from ..query.client import PointCloudClient
    from ..xray.build import XrayParameters, build_xray_quadtree
    from ..xray.quadtree import QuadNodeId

    if args.use_device:
        resolve_device(args.device)  # raises before any tile is built

    # Each tile worker streams through its own per-call client worker set;
    # keep tile_threads x client_threads ~ core count instead of the
    # default (cpus-1) PER TILE (8 tiles x 31 workers on a 32-core host).
    import os as _os

    cpus = _os.cpu_count() or 2
    tile_threads = args.num_threads or max(2, min(8, cpus))
    client = PointCloudClient.from_locations(
        args.locations, num_threads=max(1, cpus // tile_threads),
        device_filter=args.device_filter, device=args.device,
    )
    params = XrayParameters(
        output_directory=args.output_directory,
        point_cloud_client=client,
        query_from_global=apply_hook(extension, "query_from_global", args),
        filter_intervals={
            k: ClosedInterval.from_str(v) for k, v in args.filter_interval
        },
        tile_background_color=args.tile_background_color,
        tile_size_px=args.tile_size,
        pixel_size_m=args.resolution,
        root_node_id=QuadNodeId.from_str(args.root_node_id),
    )
    kwargs = {}
    if args.coloring_strategy == "colored_with_intensity":
        kwargs = {"min_intensity": args.min_intensity, "max_intensity": args.max_intensity}
    elif args.coloring_strategy == "colored_with_height_stddev":
        kwargs = {"max_stddev": args.max_stddev, "colormap": args.colormap}
    if args.binning is not None:
        name, size = args.binning
        kwargs["binning"] = (name, float(size))
    kwargs["device"] = args.device if args.use_device else None

    meta = build_xray_quadtree(
        args.coloring_strategy, params, strategy_kwargs=kwargs,
        num_threads=args.num_threads, stats=stats,
    )
    print(
        f"Built xray quadtree with {len(meta.nodes)} tiles, deepest level "
        f"{meta.deepest_level}, at {args.output_directory}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
