"""CLI: upgrade an octree meta.pb from versions 9..12 to the current
version 13 in place (reference: src/bin/upgrade_octree.rs:39-111 — the
migrations happen on decode; this tool re-serializes canonically).

Copy of point_cloud_viewer_tpu/cli/upgrade_octree.py:1-35, unchanged.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("directory", help="Octree directory with meta.pb")
    args = parser.parse_args(argv)

    from ..core.constants import CURRENT_VERSION, META_FILENAME
    from ..protos.meta import MetaProto

    path = os.path.join(args.directory, META_FILENAME)
    with open(path, "rb") as f:
        meta = MetaProto.decode(f.read())
    if meta.version == CURRENT_VERSION:
        print(f"{path} is already at version {CURRENT_VERSION}.")
        return 0
    old = meta.version
    meta.version = CURRENT_VERSION
    with open(path, "wb") as f:
        f.write(meta.encode())
    print(f"Upgraded {path} from version {old} to {CURRENT_VERSION}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
