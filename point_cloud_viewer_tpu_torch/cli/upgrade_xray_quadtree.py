"""CLI: upgrade an X-ray quadtree meta.pb from version 2 to 3 in place
(reference: xray/src/bin/upgrade_xray_quadtree.rs:31-69).

Copy of point_cloud_viewer_tpu/cli/upgrade_xray_quadtree.py:1-33, unchanged.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("directory", help="X-ray quadtree directory with meta.pb")
    args = parser.parse_args(argv)

    from ..protos.xray_meta import CURRENT_XRAY_VERSION, XrayMetaProto

    path = os.path.join(args.directory, "meta.pb")
    with open(path, "rb") as f:
        meta = XrayMetaProto.decode(f.read())
    if meta.version == CURRENT_XRAY_VERSION:
        print(f"{path} is already at version {CURRENT_XRAY_VERSION}.")
        return 0
    old = meta.version
    meta.version = CURRENT_XRAY_VERSION
    with open(path, "wb") as f:
        f.write(meta.encode())
    print(f"Upgraded {path} from version {old} to {CURRENT_XRAY_VERSION}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
