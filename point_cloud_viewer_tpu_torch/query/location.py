"""Query geometry (PointLocation) — the reference's 6 variants
(src/iterator.rs:13-20) behind one vectorized interface:

* contains(points (N, 3)) -> (N,) bool      — per-point culling
* intersects_aabbs(corners (K, 8, 3)) -> (K,) bool — node selection

Geometry variants delegate to math.geometry / math.web_mercator; S2 cell
unions live in s2_cells.cell_union.

Copy of point_cloud_viewer_tpu/query/location.py:1-95, unchanged.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np

from ..math.geometry import Aabb, Frustum, Obb
from ..math.sat import REL_OUT
from ..math.web_mercator import WebMercatorRect


class PointLocation(Protocol):
    def contains(self, points: np.ndarray) -> np.ndarray: ...

    def intersects_aabbs(self, corners: np.ndarray) -> np.ndarray: ...


class AllPoints:
    """Matches everything (reference: src/math/mod.rs:140-161)."""

    def contains(self, points: np.ndarray) -> np.ndarray:
        return np.ones(len(np.atleast_2d(points)), dtype=bool)

    def intersects_aabbs(self, corners: np.ndarray) -> np.ndarray:
        return np.ones(len(corners), dtype=bool)

    def intersects_bounds(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        return np.ones(len(lo), dtype=bool)

    def fully_inside_bounds(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        return np.ones(len(lo), dtype=bool)


class GeometryLocation:
    """Adapter for convex-polyhedron geometries (Aabb/Obb/Frustum/
    WebMercatorRect): SAT against node AABBs with cached axes."""

    def __init__(self, geometry) -> None:
        self.geometry = geometry
        self._cached_axes = None

    def contains(self, points: np.ndarray) -> np.ndarray:
        return self.geometry.contains(points)

    def _axes(self):
        if self._cached_axes is None:
            self._cached_axes = self.geometry.intersector().cached_axes_for_aabb()
        return self._cached_axes

    def intersects_aabbs(self, corners: np.ndarray) -> np.ndarray:
        return self._axes().intersect(corners) != REL_OUT

    def intersects_bounds(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """AABBs as (N, 3) lo/hi — no corner materialization (matters at
        ~1M-node scale)."""
        return self._axes().intersect_bounds(lo, hi) != REL_OUT

    def fully_inside_bounds(self, lo: np.ndarray, hi: np.ndarray):
        """(K,) bool: every point that can live inside [lo, hi] is certain
        to pass contains() — lets the client skip the per-point mask for
        interior nodes (an optimization the reference does not have; its
        FilteredIterator always tests per point, src/iterator.rs:93-119).

        Claimed ONLY where bit-exactness against the per-point test is
        provable: Aabb, whose contains() is the same component comparisons
        (half-open max, geometry.py), so `q.mins <= lo and hi < q.maxs`
        implies every p in [lo, hi] passes.  For Frustum/Obb/WebMercatorRect
        a SAT REL_IN can disagree with the exact per-point test by an ulp
        at the boundary, so returns None (caller treats as all-False)."""
        g = self.geometry
        if isinstance(g, Aabb):
            return np.all((g.mins <= lo) & (hi < g.maxs), axis=-1)
        return None


def location_for(geometry) -> PointLocation:
    """Wrap a geometry object into a PointLocation."""
    if geometry is None or isinstance(geometry, AllPoints):
        return AllPoints()
    if isinstance(geometry, (Aabb, Obb, Frustum, WebMercatorRect)):
        return GeometryLocation(geometry)
    # Already a PointLocation (e.g. s2 CellUnionLocation or custom).
    if hasattr(geometry, "contains") and hasattr(geometry, "intersects_aabbs"):
        return geometry
    raise TypeError(f"unsupported query geometry: {type(geometry)}")
