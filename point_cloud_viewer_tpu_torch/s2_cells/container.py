"""S2Cells: the geodesic point-cloud container (cells instead of octree
nodes; reference: src/s2_cells/mod.rs).

Positions are stored 'Plain' (raw little-endian f64 ECEF).  Node selection
uses each cell's conservative world AABB against the query location — the
same vectorized PointLocation interface the octree uses.

Copy of point_cloud_viewer_tpu/s2_cells/container.py:1-156, unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.attributes import AttributeDataType
from ..core.points_batch import PointsBatch
from ..io.node_io import DataProvider, OnDiskDataProvider
from ..math import s2
from ..math.geometry import Aabb
from .cell_union import CellUnion, cell_world_bounds


class S2CellId:
    """Thin node-id wrapper so S2 cells stringify to their token (the
    on-disk file stem)."""

    __slots__ = ("id",)

    def __init__(self, cell_id: int) -> None:
        self.id = int(cell_id)

    def __str__(self) -> str:
        return s2.token(self.id)

    def __repr__(self) -> str:
        return f"S2CellId({s2.token(self.id)})"

    def __eq__(self, other) -> bool:
        return isinstance(other, S2CellId) and self.id == other.id

    def __hash__(self) -> int:
        return hash(self.id)


class S2Cells:
    """An on-disk S2 point cloud opened for querying."""

    def __init__(self, data_provider: DataProvider) -> None:
        self.data_provider = data_provider
        meta = data_provider.meta_proto()
        if meta.s2 is None:
            raise ValueError("No s2 meta found")
        self.meta_version = meta.version
        self.bounding_box = Aabb(meta.bounding_box.min, meta.bounding_box.max)
        self.cell_ids = np.array([c.id for c in meta.s2.cells], dtype=np.uint64)
        self.num_points = np.array(
            [c.num_points for c in meta.s2.cells], dtype=np.int64
        )
        self.attribute_data_types: Dict[str, AttributeDataType] = {
            a.name: a.data_type for a in meta.s2.attributes
        }
        if len(self.cell_ids):
            self._bounds = cell_world_bounds(self.cell_ids)
        else:
            self._bounds = (np.empty((0, 3)), np.empty((0, 3)))

    @classmethod
    def from_directory(cls, directory: str) -> "S2Cells":
        return cls(OnDiskDataProvider(directory))

    def __len__(self) -> int:
        return len(self.cell_ids)

    def nodes_in_location(self, location) -> List[S2CellId]:
        """Cells possibly intersecting the query.  CellUnion queries use
        exact id-range overlap; geometric queries use each cell's
        conservative world AABB."""
        return [cid for cid, _ in self.nodes_in_location_ex(location)]

    def nodes_in_location_ex(self, location) -> List:
        """Like nodes_in_location but each entry is (S2CellId, fully_inside).

        fully_inside certifies every point of the cell passes the query's
        per-point test, so readers may skip per-point filtering:
        * CellUnion: a storage cell contained in the union (the same
          id-range test, contains_cell_ids) implies every point's leaf cell
          — a descendant of the storage cell by splitter assignment — is in
          the union: bit-exact.
        * Geometric: the cell's conservative world AABB bounds all its
          points (splitter-validated Earth radius band, cell_world_bounds),
          so location.fully_inside_bounds on it is sound; only Aabb queries
          claim it (see query/location.py)."""
        if len(self.cell_ids) == 0:
            return []
        if isinstance(location, CellUnion) or isinstance(
            getattr(location, "geometry", None), CellUnion
        ):
            union = location if isinstance(location, CellUnion) else location.geometry
            # Overlap if either contains the other.
            inside = union.contains_cell_ids(self.cell_ids)
            mask = inside.copy()
            for qid in union.ids:
                mask |= s2.contains(self.cell_ids, np.uint64(qid) * np.ones_like(self.cell_ids))
            return [
                (S2CellId(self.cell_ids[i]), bool(inside[i]))
                for i in np.nonzero(mask)[0]
            ]
        lo, hi = self._bounds
        if hasattr(location, "intersects_bounds"):
            mask = location.intersects_bounds(lo, hi)
        else:
            mask = location.intersects_aabbs(_bounds_to_corners(lo, hi))
        # Tighten with the reference's rect-bound covering
        # (src/s2_cells/mod.rs:219-233): the query corners' lat/lng rect
        # against each cell's rect.  Both filters are conservative, so
        # their intersection still keeps every truly intersecting cell
        # while over-fetching strictly less.
        geometry = getattr(location, "geometry", None)
        query_corners = getattr(geometry, "corners", None)
        if query_corners is not None and mask.any():
            rect = s2.LatLngRect.from_points(query_corners())
            sel = np.nonzero(mask)[0]
            mask[sel] &= rect.intersects_cells(self.cell_ids[sel])
        idx = np.nonzero(mask)[0]
        fib = getattr(location, "fully_inside_bounds", None)
        fully = fib(lo[idx], hi[idx]) if (fib is not None and len(idx)) else None
        if fully is None:
            fully = np.zeros(len(idx), dtype=bool)
        return [
            (S2CellId(self.cell_ids[i]), bool(f)) for i, f in zip(idx, fully)
        ]

    def points_in_node(
        self, node_id: S2CellId, attributes: Optional[Sequence[str]] = None
    ) -> PointsBatch:
        if attributes is None:
            attributes = list(self.attribute_data_types)
        for a in attributes:
            if a not in self.attribute_data_types:
                raise KeyError(f"Data type for attribute '{a}' not found.")
        from ..io.node_io import parse_attribute_bytes

        blobs = self.data_provider.data(str(node_id), ["position", *attributes])
        position = np.frombuffer(blobs["position"], dtype="<f8").reshape(-1, 3)
        attrs = {
            a: parse_attribute_bytes(blobs[a], self.attribute_data_types[a])
            for a in attributes
        }
        return PointsBatch(position=position, attributes=attrs)


def _bounds_to_corners(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(K, 3) lo/hi -> (K, 8, 3) corners."""
    unit = np.array(
        [[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)], dtype=np.float64
    )
    return lo[:, None, :] + unit[None, :, :] * (hi - lo)[:, None, :]
