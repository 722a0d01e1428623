"""CellUnion: a set of S2 cells usable as query geometry.

Point containment is exact (id-range membership, vectorized binary search).
Node selection against AABBs is conservative: each query cell is expanded
into a world-space box (corner directions extruded over the valid Earth
radius band, padded by the cell's sagitta bound) and overlap-tested —
replacing the reference's rect_bound heuristic
(src/geometry/s2_cell_union.rs:15-44) with a purely vectorized test.

Copy of point_cloud_viewer_tpu/s2_cells/cell_union.py:1-100, unchanged.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..math import s2
from ..math.wgs84 import EARTH_RADIUS_MAX_M, EARTH_RADIUS_MIN_M


class CellUnion:
    """A normalized union of S2 cells."""

    def __init__(self, cell_ids: Sequence[int]) -> None:
        ids = sorted(int(c) for c in cell_ids)
        # Normalize: drop cells contained in another cell of the union
        # (s2geometry CellUnion::Normalize).  Ids sort by leaf position, so
        # a parent's id sits in the MIDDLE of its range — a child from the
        # lower half sorts BEFORE its parent.  Containment must therefore
        # be checked BOTH ways: skip a new cell contained in the last kept
        # one, and pop kept cells contained in the new one (only tail cells
        # can be: any earlier container would already have absorbed them).
        keep: list = []
        keep_hi: list = []
        for cid in ids:
            lo, hi = int(s2.range_min(cid)), int(s2.range_max(cid))
            if keep and cid <= keep_hi[-1]:
                continue  # contained in (or equal to) the last kept cell
            while keep and lo <= keep[-1]:
                keep.pop()  # kept tail cell is contained in this one
                keep_hi.pop()
            keep.append(cid)
            keep_hi.append(hi)
        self.ids = np.array(keep, dtype=np.uint64)
        self._range_min = s2.range_min(self.ids)
        self._range_max = s2.range_max(self.ids)

    def __len__(self) -> int:
        return len(self.ids)

    def contains_cell_ids(self, ids: np.ndarray) -> np.ndarray:
        """(N,) ids -> (N,) bool: is each id inside the union?"""
        ids = np.asarray(ids, dtype=np.uint64)
        pos = np.searchsorted(self._range_min, ids, side="right") - 1
        pos_clamped = np.clip(pos, 0, max(len(self.ids) - 1, 0))
        ok = (pos >= 0) & (len(self.ids) > 0)
        return ok & (ids <= self._range_max[pos_clamped])

    # -- PointLocation interface ------------------------------------------

    def contains(self, points: np.ndarray) -> np.ndarray:
        leaves = s2.leaf_cell_ids_from_points(np.atleast_2d(points))
        return self.contains_cell_ids(leaves)

    def intersects_aabbs(self, corners: np.ndarray) -> np.ndarray:
        """(K, 8, 3) AABB corner sets -> (K,) bool, conservative."""
        return self.intersects_bounds(corners.min(axis=1), corners.max(axis=1))

    def intersects_bounds(self, box_lo: np.ndarray, box_hi: np.ndarray) -> np.ndarray:
        """AABBs as (K, 3) lo/hi pairs -> (K,) bool, conservative."""
        if len(self.ids) == 0:
            return np.zeros(len(box_lo), dtype=bool)
        cell_lo, cell_hi = cell_world_bounds(self.ids)
        # Overlap of each box with ANY cell bound.
        overlap = np.all(
            (box_lo[:, None, :] <= cell_hi[None, :, :])
            & (box_hi[:, None, :] >= cell_lo[None, :, :]),
            axis=2,
        )
        return overlap.any(axis=1)


def cell_world_bounds(ids: np.ndarray) -> tuple:
    """Conservative world-space AABBs covering each cell's volume over the
    Earth radius band: returns (lo (K, 3), hi (K, 3)).

    The spherical patch bulges at most sagitta = R*(1 - cos(theta/2))
    outside the corner chords; we pad by that bound."""
    ids = np.asarray(ids, dtype=np.uint64)
    corners = s2.cell_corners_xyz(ids)  # (K, 4, 3) unit directions
    level = s2.level_of(ids)
    # Max angular edge of a level-L cell is <= ~1.8 * 2^-L radians.
    theta = np.minimum(1.8 * np.exp2(-level.astype(np.float64)), np.pi)
    pad = EARTH_RADIUS_MAX_M * (1.0 - np.cos(theta)) + 1.0
    pts = np.concatenate(
        [corners * EARTH_RADIUS_MIN_M, corners * EARTH_RADIUS_MAX_M], axis=1
    )  # (K, 8, 3)
    lo = pts.min(axis=1) - pad[:, None]
    hi = pts.max(axis=1) + pad[:, None]
    return lo, hi
