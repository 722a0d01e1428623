"""CLI: serve an X-ray quadtree over HTTP (reference:
xray/src/bin/web_viewer.rs).

Copy of point_cloud_viewer_tpu/cli/xray_web_viewer.py:1-24, unchanged.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("directory", help="X-ray quadtree directory.")
    parser.add_argument("--ip", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=5434)
    args = parser.parse_args(argv)

    from ..xray.backend import serve_forever

    serve_forever(args.directory, ip=args.ip, port=args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
