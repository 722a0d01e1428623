"""CLI: serve octrees over HTTP for the web viewer (reference:
octree_web_viewer/src/bin/points_web_viewer.rs).

Usage: python -m point_cloud_viewer_tpu_torch.cli.points_web_viewer DIR \
           [--ip 127.0.0.1] [--port 5433]

DIR may be a single octree directory (served under id '.') or, with
--prefix/--suffix, trees are resolved as <prefix>/<id>/<suffix>.

Copy of point_cloud_viewer_tpu/cli/points_web_viewer.py:1-52; only the
module path in the usage line differs.  The server culls on the host
(Octree.visible_node_names_json), as the JAX package's does.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("octree", nargs="?", help="Single octree directory to serve.")
    parser.add_argument("--prefix", default=None, help="Octree path prefix.")
    parser.add_argument("--suffix", default="", help="Octree path suffix.")
    parser.add_argument("--init_id", default=None, help="Initial octree id.")
    parser.add_argument("--ip", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=5433)
    args = parser.parse_args(argv)

    from ..viewer.web_backend import AppState, serve_forever

    if args.octree:
        directory = args.octree.rstrip("/")
        prefix = os.path.dirname(directory) or "."
        init_id = os.path.basename(directory)
    elif args.prefix is not None:
        if not args.init_id:
            # An empty initial id leaves the bundled client fetching
            # /visible_nodes// (404) and stuck on "loading..."; the
            # reference always derives an id from its octree path.
            parser.error("--prefix requires --init_id (the initial tree "
                         "the web client loads)")
        prefix = args.prefix
        init_id = args.init_id
    else:
        parser.error("provide an octree directory or --prefix")
        return 2
    state = AppState(prefix=prefix, suffix=args.suffix, init_octree_id=init_id)
    serve_forever(state, ip=args.ip, port=args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
