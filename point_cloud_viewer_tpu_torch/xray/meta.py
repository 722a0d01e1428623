"""X-ray quadtree metadata wrapper: load/save meta.pb and select tiles for
a zoom level within a view frustum (reference: xray/src/lib.rs:32-220).

Node selection is vectorized: all existing nodes at the level are tested at
once (one SAT pass over extruded tile rects) instead of a recursive walk —
note the existence chain still matters (a node is reachable only if its
ancestors exist), which holds by construction of the build pipeline.

Copy of point_cloud_viewer_tpu/xray/meta.py:1-131, unchanged.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Set

import numpy as np

from ..math.geometry import Frustum
from ..math.sat import REL_OUT
from ..protos.xray_meta import (
    CURRENT_XRAY_VERSION,
    RectProto,
    XrayMetaProto,
    XrayNodeIdProto,
)
from .quadtree import QuadNodeId, Rect, node_rects

META_FILENAME = "meta.pb"


@dataclass
class TileMeta:
    id: str
    min_x: float
    min_y: float
    edge_length: float


class XrayMeta:
    def __init__(self, proto: XrayMetaProto) -> None:
        self.version = proto.version
        self.bounding_rect = Rect(
            proto.bounding_rect.min[0],
            proto.bounding_rect.min[1],
            proto.bounding_rect.edge_length,
        )
        self.tile_size = proto.tile_size
        self.deepest_level = proto.deepest_level
        self.nodes: Set[QuadNodeId] = {
            QuadNodeId(n.level, n.index) for n in proto.nodes
        }

    @classmethod
    def from_directory(cls, directory: str, filename: str = META_FILENAME) -> "XrayMeta":
        with open(os.path.join(directory, filename), "rb") as f:
            return cls(XrayMetaProto.decode(f.read()))

    def to_proto(self) -> XrayMetaProto:
        return XrayMetaProto(
            version=CURRENT_XRAY_VERSION,
            bounding_rect=RectProto(
                min=(self.bounding_rect.min_x, self.bounding_rect.min_y),
                edge_length=self.bounding_rect.edge_length,
            ),
            deepest_level=self.deepest_level,
            tile_size=self.tile_size,
            nodes=[
                XrayNodeIdProto(level=n.level, index=n.index)
                for n in sorted(self.nodes)
            ],
        )

    def save(self, directory: str, filename: str = META_FILENAME) -> None:
        with open(os.path.join(directory, filename), "wb") as f:
            f.write(self.to_proto().encode())

    def root_node(self) -> Optional[QuadNodeId]:
        if not self.nodes:
            return None
        return min(self.nodes, key=lambda n: n.level)

    def iter_level(self, level: int) -> List[QuadNodeId]:
        return [n for n in self.nodes if n.level == level]

    def get_nodes_for_level(
        self, level: int, matrix_entries: List[float]
    ) -> List[TileMeta]:
        """Tiles at `level` whose (z-extruded) rect intersects the frustum
        given as a column-major 4x4 matrix (the web client's request)."""
        if len(matrix_entries) != 16:
            raise ValueError(
                f"Expected 16 entries in matrix, got {len(matrix_entries)}"
            )
        matrix = np.array(matrix_entries, dtype=np.float64).reshape(4, 4).T
        frustum = Frustum.from_matrix4(matrix)
        cached = frustum.intersector().cached_axes_for_aabb()

        ids = self.iter_level(level)
        if not ids:
            return []
        rects = node_rects(ids, self.bounding_rect)  # (K, 3)
        corners = _extruded_rect_corners(rects)
        rel = cached.intersect(corners)
        out = []
        for i in np.nonzero(rel != REL_OUT)[0]:
            out.append(
                TileMeta(
                    id=str(ids[i]),
                    min_x=rects[i, 0],
                    min_y=rects[i, 1],
                    edge_length=rects[i, 2],
                )
            )
        return out


def _extruded_rect_corners(rects: np.ndarray) -> np.ndarray:
    """(K, 3) [min_x, min_y, edge] -> (K, 8, 3) corners with z in
    [-0.1, 0.1] (the reference's flat extrusion, xray/src/lib.rs:193-197)."""
    k = len(rects)
    corners = np.empty((k, 8, 3))
    xs = np.stack([rects[:, 0], rects[:, 0] + rects[:, 2]], axis=1)
    ys = np.stack([rects[:, 1], rects[:, 1] + rects[:, 2]], axis=1)
    c = 0
    for z in (-0.1, 0.1):
        for yi in (0, 1):
            for xi in (0, 1):
                corners[:, c, 0] = xs[:, xi]
                corners[:, c, 1] = ys[:, yi]
                corners[:, c, 2] = z
                c += 1
    return corners
