"""CLI: build an S2-cell point cloud from a PLY of ECEF points.

The reference exposes S2 building through its library (S2Splitter,
src/read_write/s2.rs); this CLI wraps the same capability.

Copy of point_cloud_viewer_tpu/cli/build_s2.py:1-36, unchanged.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input", help="PLY file with ECEF points.")
    parser.add_argument("--output_directory", required=True)
    parser.add_argument("--split_level", type=int, default=20)
    args = parser.parse_args(argv)

    from ..io.ply import PlyReader
    from ..s2_cells.splitter import S2Splitter

    splitter = S2Splitter(args.output_directory, split_level=args.split_level)
    reader = PlyReader(args.input)
    for batch in reader:
        splitter.write(batch)
    meta = splitter.finish()
    print(
        f"Built S2 cloud with {sum(c.num_points for c in meta.s2.cells)} points "
        f"in {len(meta.s2.cells)} cells at {args.output_directory}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
