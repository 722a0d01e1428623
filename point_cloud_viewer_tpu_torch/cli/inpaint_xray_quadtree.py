"""CLI: inpaint holes in a (possibly partial) X-ray quadtree's leaf tiles
and rebuild the pyramid (reference: xray/src/bin/inpaint_xray_quadtree.rs).

For a partial quadtree (--root_node_id other than "r"), the input
directory is expected to also contain the four side-adjacent quadtrees'
``meta<id>.pb`` files and their border leaf tiles (copied in by the
caller, exactly as the reference documents at
inpaint_xray_quadtree.rs:20-24); hole filling then samples across the
dataset border, and the imported tiles are removed from the output
afterwards (inpaint_xray_quadtree.rs:138-143).

Copy of point_cloud_viewer_tpu/cli/inpaint_xray_quadtree.py:1-121, unchanged.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

from .build_xray_quadtree import _parse_color


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "input_directory",
        help="Directory with the (possibly partial) quadtree to be "
        "inpainted. Needs to include all border leaf tiles of the "
        "neighboring quadtrees as well for smooth inpainting results.",
    )
    parser.add_argument(
        "--output_directory", default=None,
        help="Directory where to write the inpainted quadtree. Does NOT "
        "have to be disjoint from input_directory (defaults to in-place).",
    )
    parser.add_argument(
        "--root_node_id", default="r",
        help="The root node id to start inpainting with (partial "
        "quadtrees are named meta<id>.pb; reference "
        "inpaint_xray_quadtree.rs:36-39).",
    )
    parser.add_argument(
        "--inpaint_distance_px", "--inpaint_distance", type=int, default=3,
        dest="inpaint_distance_px",
        help="Maximum hole radius (in pixels) to fill.",
    )
    parser.add_argument("--num_threads", type=int, default=8)
    parser.add_argument(
        "--tile_background_color", default=(255, 255, 255, 255),
        type=_parse_color,
        help="Background assigned to sub-threshold-alpha leaf pixels after "
        "inpainting, R,G,B[,A] (reference inpaint_xray_quadtree.rs:128).",
    )
    args = parser.parse_args(argv)

    from ..xray.build import (
        assign_background_color,
        create_non_leaf_nodes,
        image_path,
        meta_pb_path,
    )
    from ..xray.inpaint import get_adjacent_leaf_node_ids, perform_inpainting
    from ..xray.meta import XrayMeta
    from ..xray.quadtree import QuadNodeId

    input_directory = os.path.realpath(args.input_directory)
    output_directory = os.path.realpath(
        args.output_directory if args.output_directory else args.input_directory
    )
    root_node_id = QuadNodeId.from_str(args.root_node_id)
    meta_name = os.path.basename(meta_pb_path(input_directory, root_node_id))
    meta = XrayMeta.from_directory(input_directory, meta_name)
    leaves = set(meta.iter_level(meta.deepest_level))

    adjacent = get_adjacent_leaf_node_ids(leaves, input_directory, root_node_id)
    if root_node_id.level != 0 and not adjacent:
        print(
            "No adjacent leaf nodes found in neighboring quadtrees. "
            f"Did you forget to copy them into {input_directory!r}?",
            file=sys.stderr,
        )

    in_place = input_directory == output_directory
    if not in_place:
        os.makedirs(output_directory, exist_ok=True)
        shutil.copy(
            meta_pb_path(input_directory, root_node_id),
            meta_pb_path(output_directory, root_node_id),
        )
        for node_id in leaves | adjacent:
            shutil.copy(
                image_path(input_directory, node_id),
                image_path(output_directory, node_id),
            )

    perform_inpainting(
        output_directory, args.inpaint_distance_px, sorted(leaves),
        num_threads=args.num_threads,
    )
    print(
        f"Inpainted {len(leaves)} leaf tiles "
        f"(distance {args.inpaint_distance_px}px, "
        f"{len(adjacent)} imported border tiles)."
    )
    # The reference tool ALWAYS runs these two steps after inpainting
    # (inpaint_xray_quadtree.rs:127-136): assign the background color to
    # leaves, then rebuild every ancestor so the pyramid shows the
    # inpainted content instead of the stale holes.
    assign_background_color(output_directory, args.tile_background_color, leaves)
    create_non_leaf_nodes(
        leaves, meta.deepest_level, root_node_id.level,
        output_directory, args.tile_background_color, meta.tile_size,
    )
    if not in_place:
        for node_id in adjacent:
            os.remove(image_path(output_directory, node_id))
    print("Assigned background color and rebuilt pyramid.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
