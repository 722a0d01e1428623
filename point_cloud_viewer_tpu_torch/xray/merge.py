"""Merge partially-built X-ray quadtrees (reference:
xray/src/bin/merge_xray_quadtrees.rs:129-223).

Partial builds (--root_node_id) produce `meta<id>.pb` files plus tiles for
the subtree under <id>.  Merging validates that all parts agree on tile
size, deepest level, and bounding rect, unions their node sets, copies
tiles into the output directory, rebuilds the shared ancestors bottom-up,
and writes the unified meta.pb.

Copy of point_cloud_viewer_tpu/xray/merge.py:1-111, unchanged.
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import List, Set, Tuple

from .build import build_node, image_path
from .meta import XrayMeta
from .quadtree import QuadNodeId


def find_partial_metas(directories: List[str]) -> List[Tuple[str, str, QuadNodeId]]:
    """-> [(directory, meta filename, root node id)] for every meta*.pb."""
    out = []
    for d in directories:
        for path in sorted(glob.glob(os.path.join(d, "meta*.pb"))):
            stem = os.path.splitext(os.path.basename(path))[0]
            node_name = stem.replace("meta", "r", 1)
            out.append((d, os.path.basename(path), QuadNodeId.from_str(node_name)))
    return out


def merge_xray_quadtrees(
    output_directory: str,
    input_directories: List[str],
    tile_background_color=(255, 255, 255, 255),
) -> XrayMeta:
    parts = find_partial_metas(input_directories)
    if not parts:
        raise ValueError("no meta*.pb files found in input directories")
    metas = [XrayMeta.from_directory(d, f) for d, f, _ in parts]
    roots = [r for _, _, r in parts]

    first = metas[0]
    # A partial meta's bounding_rect is the SUBTREE root's rect (reference:
    # generation.rs:604-613); reconstruct each part's global root rect by
    # inverting the root->subtree descent and compare those.
    global_rects = [
        _global_rect(m.bounding_rect, r) for m, r in zip(metas, roots)
    ]
    g0 = global_rects[0]
    for m, g in zip(metas[1:], global_rects[1:]):
        if m.tile_size != first.tile_size:
            raise ValueError("tile sizes differ between quadtrees")
        if m.deepest_level != first.deepest_level:
            raise ValueError("deepest levels differ between quadtrees")
        if (
            abs(g.min_x - g0.min_x) > 1e-9
            or abs(g.min_y - g0.min_y) > 1e-9
            or abs(g.edge_length - g0.edge_length) > 1e-9
        ):
            raise ValueError("bounding rects differ between quadtrees")
    root_levels = {r.level for r in roots}
    if len(root_levels) != 1:
        raise ValueError("all subtree roots must be at the same level")
    root_level = root_levels.pop()

    os.makedirs(output_directory, exist_ok=True)
    all_nodes: Set[QuadNodeId] = set()
    for (d, _, _), m in zip(parts, metas):
        for node in m.nodes:
            src = image_path(d, node)
            dst = image_path(output_directory, node)
            if os.path.abspath(src) != os.path.abspath(dst) and os.path.exists(src):
                shutil.copyfile(src, dst)
        overlap = all_nodes & m.nodes
        if overlap:
            raise ValueError(f"quadtrees overlap in {len(overlap)} nodes")
        all_nodes |= m.nodes

    # Rebuild shared ancestors of the subtree roots.
    current = set(roots)
    for level in range(root_level - 1, -1, -1):
        current = {n.parent() for n in current}
        for node in current:
            build_node(output_directory, node, first.tile_size, tile_background_color)
        all_nodes |= current

    merged = XrayMeta.from_directory(parts[0][0], parts[0][1])
    merged.nodes = all_nodes
    merged.deepest_level = first.deepest_level
    merged.tile_size = first.tile_size
    merged.bounding_rect = g0
    merged.save(output_directory)
    return merged


def _global_rect(subtree_rect, root_id: QuadNodeId):
    """Invert QuadNodeId.find_bounding_rect: subtree rect -> global rect."""
    from .quadtree import Rect

    mx, my = subtree_rect.min_x, subtree_rect.min_y
    edge = subtree_rect.edge_length
    for l in range(root_id.level):
        child = (root_id.index >> (2 * l)) & 3
        if child & 0b10:
            mx -= edge
        if child & 0b01:
            my -= edge
        edge *= 2.0
    return Rect(mx, my, edge)
