"""CLI: merge partially-built X-ray quadtrees (reference:
xray/src/bin/merge_xray_quadtrees.rs).

Copy of point_cloud_viewer_tpu/cli/merge_xray_quadtrees.py:1-30, unchanged.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("inputs", nargs="+", help="Directories with meta*.pb parts.")
    parser.add_argument("--output_directory", required=True)
    parser.add_argument(
        "--tile_background_color", default="255,255,255,255",
        help="R,G,B,A used when rebuilding shared ancestors.",
    )
    args = parser.parse_args(argv)

    from ..xray.merge import merge_xray_quadtrees

    color = tuple(int(v) for v in args.tile_background_color.split(","))
    meta = merge_xray_quadtrees(args.output_directory, args.inputs, color)
    print(f"Merged {len(args.inputs)} inputs into {args.output_directory}: "
          f"{len(meta.nodes)} tiles.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
