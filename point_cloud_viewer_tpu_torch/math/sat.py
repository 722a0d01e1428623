"""Separating-axis-theorem intersection engine, vectorized.

The reference tests one pair of convex polyhedra at a time with lazy axis
iterators (reference: src/math/sat.rs:67-205).  Here the primitive is
*one query polyhedron against a batch of N corner sets*: corners are (N, 8, 3)
arrays, axis projection is a single (N*8, 3) x (3, A) matmul, and the In /
Cross / Out relation comes out as an (N,) integer array.  This shape maps
directly onto the TPU MXU and is used by node culling, visible-node
selection, and the query planner.

Relations are encoded as integers: REL_IN=0, REL_CROSS=1, REL_OUT=2 (ordering
chosen so that `max` over parts composes like the reference's enum).

Copy of point_cloud_viewer_tpu/math/sat.py:1-141 with one deviation:
`dedup_axes` compares every pair of axes in one vectorised pass instead of
a Python double loop, and keeps the same rows (so the same bits).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

REL_IN = 0
REL_CROSS = 1
REL_OUT = 2

_X_AXIS = np.array([1.0, 0.0, 0.0])
_Y_AXIS = np.array([0.0, 1.0, 0.0])
_Z_AXIS = np.array([0.0, 0.0, 1.0])
UNIT_AXES = np.stack([_X_AXIS, _Y_AXIS, _Z_AXIS])


@dataclass
class Intersector:
    """Sufficient statistics of a convex polyhedron for SAT tests:
    corners (8, 3), unit edge directions (E, 3), unit face normals (F, 3)."""

    corners: np.ndarray
    edges: np.ndarray
    face_normals: np.ndarray

    def separating_axes_with(
        self, other_edges: np.ndarray, other_face_normals: np.ndarray
    ) -> np.ndarray:
        """All candidate separating axes against an object with the given
        edges/normals: our normals, their normals, and normalized cross
        products of every edge pair (non-finite results dropped)."""
        crosses = np.cross(self.edges[:, None, :], other_edges[None, :, :]).reshape(-1, 3)
        norms = np.linalg.norm(crosses, axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            crosses = crosses / norms[:, None]
        crosses = crosses[np.isfinite(crosses).all(axis=1)]
        return np.concatenate([self.face_normals, other_face_normals, crosses])

    def cached_axes(
        self, other_edges: np.ndarray, other_face_normals: np.ndarray
    ) -> "CachedAxes":
        axes = dedup_axes(self.separating_axes_with(other_edges, other_face_normals))
        return CachedAxes(axes=axes, corners=self.corners)

    def cached_axes_for_aabb(self) -> "CachedAxes":
        """Axes for testing against any AABB (whose edges/normals are the
        unit axes) — reference: src/math/sat.rs:141-148."""
        return self.cached_axes(UNIT_AXES, UNIT_AXES)

    def intersect(self, other: "Intersector") -> int:
        axes = self.separating_axes_with(other.edges, other.face_normals)
        return int(
            sat_relation(axes, self.corners, other.corners[None, ...])[0]
        )


@dataclass
class CachedAxes:
    """Precomputed separating axes + query corners, for one-vs-many tests."""

    axes: np.ndarray  # (A, 3)
    corners: np.ndarray  # (8, 3)

    def intersect(self, corners: np.ndarray) -> np.ndarray:
        """corners: (N, 8, 3) or (8, 3) → relation array (N,) or scalar."""
        single = corners.ndim == 2
        rel = sat_relation(self.axes, self.corners, corners[None, ...] if single else corners)
        return int(rel[0]) if single else rel

    def intersect_bounds(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """SAT relations for AXIS-ALIGNED boxes given as (N, 3) lo/hi pairs,
        without materializing (N, 8, 3) corners: the projection interval of
        a box onto axis a is [lo@max(a,0) + hi@min(a,0),
        lo@min(a,0) + hi@max(a,0)] — O(N*A) memory instead of O(N*8*3)."""
        pos = np.maximum(self.axes, 0.0)  # (A, 3)
        neg = np.minimum(self.axes, 0.0)
        b_min = lo @ pos.T + hi @ neg.T  # (N, A)
        b_max = lo @ neg.T + hi @ pos.T
        proj_a = self.corners @ self.axes.T
        a_min = proj_a.min(axis=0)
        a_max = proj_a.max(axis=0)
        out = np.any((b_min > a_max) | (b_max < a_min), axis=1)
        cross = np.any((a_min > b_min) | (b_max > a_max), axis=1)
        return np.where(out, REL_OUT, np.where(cross, REL_CROSS, REL_IN)).astype(np.int8)


def dedup_axes(axes: np.ndarray, eps: float = 2.220446049250313e-16) -> np.ndarray:
    """Drop axes that duplicate an earlier one up to sign
    (reference dedup criterion: src/math/sat.rs:119-130).

    Greedy, as the reference's loop: row i is kept unless a KEPT earlier
    row j has min(|a_i - a_j|^2, |a_i + a_j|^2) < eps.  Every pair's
    squared distances come from one broadcast, their three terms summed
    left to right as np.sum sums a 3-vector, and min is Python's (a NaN
    first operand wins), so the keep decisions are the loop's."""
    axes = np.asarray(axes)
    n = len(axes)
    if n == 0:
        return np.empty((0, 3))
    # a_i - (-a_j) is a_i + a_j to the bit, so one subtraction gives both.
    sq = (axes[:, None, :] - np.concatenate([axes, -axes])[None, :, :]) ** 2
    d = sq[..., 0] + sq[..., 1] + sq[..., 2]
    d1, d2 = d[:, :n], d[:, n:]
    close = np.tril(np.where(d2 < d1, d2, d1) < eps, -1)
    keep = ~close.any(axis=1)
    # A row close to an earlier one goes only if one of those was kept.
    for i in np.flatnonzero(~keep):
        keep[i] = not close[i, :i][keep[:i]].any()
    return axes[keep]


def sat_relation(
    axes: np.ndarray, corners_a: np.ndarray, corners_b: np.ndarray
) -> np.ndarray:
    """Batched SAT: how is each corner set in `corners_b` (N, 8, 3) related
    to the polyhedron with `corners_a` (8, 3)?  Returns (N,) ints.

    REL_IN means B is completely inside A (reference: src/math/sat.rs:174-205).
    Works with numpy or jax.numpy arrays (the caller picks the namespace by
    passing that namespace's arrays)."""
    xp = np  # numpy host path; jitted variant lives in ops/culling.py
    proj_a = corners_a @ axes.T  # (8, A)
    a_min = proj_a.min(axis=0)  # (A,)
    a_max = proj_a.max(axis=0)
    proj_b = corners_b @ axes.T  # (N, 8, A)
    b_min = proj_b.min(axis=1)  # (N, A)
    b_max = proj_b.max(axis=1)
    out = xp.any((b_min > a_max) | (b_max < a_min), axis=1)
    cross = xp.any((a_min > b_min) | (b_max > a_max), axis=1)
    return xp.where(out, REL_OUT, xp.where(cross, REL_CROSS, REL_IN)).astype(np.int8)


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=-1, keepdims=True)
