"""Geometric primitives: Aabb, Cube, Obb, Perspective, Frustum.

Containment tests are vectorized over (N, 3) point arrays (the reference
tests one Point3 at a time — src/geometry/*.rs); SAT statistics (corners,
edges, normals) are produced as arrays for `math.sat`.

Semantics preserved from the reference:
* Aabb.contains is half-open: min <= p < max       (src/geometry/aabb.rs:46-48)
* Obb.contains is closed: |local p| <= half_extent (src/geometry/obb.rs:84-90)
* Frustum.contains is open: -1 < clip p < 1        (src/geometry/frustum.rs:121-125)

Copy of point_cloud_viewer_tpu/math/geometry.py:1-316, unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .sat import Intersector, UNIT_AXES, normalize


# ---------------------------------------------------------------------------
# Isometry (rotation + translation), the pose type used by Obb/Frustum.


@dataclass
class Isometry:
    """Rigid transform p -> R @ p + t."""

    rotation: np.ndarray  # (3, 3)
    translation: np.ndarray  # (3,)

    @classmethod
    def identity(cls) -> "Isometry":
        return cls(np.eye(3), np.zeros(3))

    @classmethod
    def from_quaternion(
        cls, w: float, x: float, y: float, z: float, translation=(0.0, 0.0, 0.0)
    ) -> "Isometry":
        n = (w * w + x * x + y * y + z * z) ** 0.5
        w, x, y, z = w / n, x / n, y / n, z / n
        rot = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        return cls(rot, np.asarray(translation, dtype=np.float64))

    @classmethod
    def from_axis_angle(cls, axis, angle: float, translation=(0.0, 0.0, 0.0)) -> "Isometry":
        axis = normalize(np.asarray(axis, dtype=np.float64))
        half = angle / 2.0
        s = np.sin(half)
        return cls.from_quaternion(np.cos(half), *(axis * s), translation=translation)

    def inverse(self) -> "Isometry":
        rt = self.rotation.T
        return Isometry(rt, -rt @ self.translation)

    def compose(self, other: "Isometry") -> "Isometry":
        """self ∘ other (apply `other` first)."""
        return Isometry(
            self.rotation @ other.rotation,
            self.rotation @ other.translation + self.translation,
        )

    def transform_points(self, points: np.ndarray) -> np.ndarray:
        return points @ self.rotation.T + self.translation

    def transform_vectors(self, vectors: np.ndarray) -> np.ndarray:
        return vectors @ self.rotation.T

    def to_matrix4(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = self.rotation
        m[:3, 3] = self.translation
        return m


# ---------------------------------------------------------------------------
# Aabb / Cube


_CORNER_SIGNS = np.array(
    [[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)], dtype=np.float64
)  # (8, 3): x fastest — any fixed order works for SAT min/max statistics.


@dataclass
class Aabb:
    """Axis-aligned box; construction normalizes min/max elementwise."""

    mins: np.ndarray
    maxs: np.ndarray

    def __init__(self, mins, maxs) -> None:
        mins = np.asarray(mins, dtype=np.float64)
        maxs = np.asarray(maxs, dtype=np.float64)
        self.mins = np.minimum(mins, maxs)
        self.maxs = np.maximum(mins, maxs)

    @classmethod
    def zero(cls) -> "Aabb":
        return cls(np.zeros(3), np.zeros(3))

    @classmethod
    def bounding_points(cls, points: np.ndarray) -> "Aabb":
        """The bounding box of an (N, 3) point array — vectorized equivalent
        of the reference's grow() pass (src/octree/generation.rs:256-270)."""
        if len(points) == 0:
            return cls.zero()
        return cls(points.min(axis=0), points.max(axis=0))

    def grow(self, p: np.ndarray) -> None:
        self.mins = np.minimum(self.mins, p)
        self.maxs = np.maximum(self.maxs, p)

    def center(self) -> np.ndarray:
        return (self.mins + self.maxs) / 2.0

    def diag(self) -> np.ndarray:
        return self.maxs - self.mins

    def contains(self, points: np.ndarray) -> np.ndarray:
        """(N, 3) -> (N,) bool; half-open min <= p < max."""
        points = np.atleast_2d(points)
        return np.all((self.mins <= points) & (points < self.maxs), axis=-1)

    def corners(self) -> np.ndarray:
        return self.mins + _CORNER_SIGNS * self.diag()

    def intersector(self) -> Intersector:
        return Intersector(corners=self.corners(), edges=UNIT_AXES.copy(), face_normals=UNIT_AXES.copy())

    def transform(self, iso: Isometry) -> "Aabb":
        c = iso.transform_points(self.corners())
        return Aabb(c.min(axis=0), c.max(axis=0))

    def to_obb(self) -> "Obb":
        return Obb(Isometry(np.eye(3), self.center()), self.diag() * 0.5)


@dataclass
class Cube:
    """Axis-aligned cube (an octree node's bounds)."""

    min: np.ndarray
    edge_length: float

    def __init__(self, min, edge_length: float) -> None:
        self.min = np.asarray(min, dtype=np.float64)
        self.edge_length = float(edge_length)

    @classmethod
    def bounding(cls, aabb: Aabb) -> "Cube":
        """The cube with the aabb's min corner and its longest side
        (reference: src/geometry/aabb.rs:148-156) — the octree root cube."""
        return cls(aabb.mins, float(aabb.diag().max()))

    def max(self) -> np.ndarray:
        return self.min + self.edge_length

    def center(self) -> np.ndarray:
        return self.min + self.edge_length / 2.0

    def to_aabb(self) -> Aabb:
        return Aabb(self.min, self.max())

    def corners(self) -> np.ndarray:
        return self.min + _CORNER_SIGNS * self.edge_length


# ---------------------------------------------------------------------------
# Obb


class Obb:
    """Oriented bounding box: pose (query_from_obb) + half extents."""

    def __init__(self, query_from_obb: Isometry, half_extent) -> None:
        self.query_from_obb = query_from_obb
        self.obb_from_query = query_from_obb.inverse()
        self.half_extent = np.asarray(half_extent, dtype=np.float64)

    def contains(self, points: np.ndarray) -> np.ndarray:
        local = self.obb_from_query.transform_points(np.atleast_2d(points))
        return np.all(np.abs(local) <= self.half_extent, axis=-1)

    def corners(self) -> np.ndarray:
        # Order matches reference compute_corners (x varies fastest).
        signs = _CORNER_SIGNS * 2.0 - 1.0
        return self.query_from_obb.transform_points(signs * self.half_extent)

    def intersector(self) -> Intersector:
        axes = self.query_from_obb.transform_vectors(UNIT_AXES)
        axes = normalize(axes)
        return Intersector(corners=self.corners(), edges=axes, face_normals=axes.copy())

    def transformed(self, global_from_query: Isometry) -> "Obb":
        return Obb(global_from_query.compose(self.query_from_obb), self.half_extent)


# ---------------------------------------------------------------------------
# Perspective + Frustum


class Perspective:
    """Asymmetric perspective projection (reference: src/geometry/frustum.rs:11-87)."""

    def __init__(self, left: float, right: float, bottom: float, top: float,
                 near: float, far: float) -> None:
        if not (left < right and bottom < top and 0.0 < near < far):
            raise ValueError("invalid perspective parameters")
        m = np.zeros((4, 4))
        m[0, 0] = 2.0 * near / (right - left)
        m[0, 2] = (right + left) / (right - left)
        m[1, 1] = 2.0 * near / (top - bottom)
        m[1, 2] = (top + bottom) / (top - bottom)
        m[2, 2] = -(far + near) / (far - near)
        m[2, 3] = -(2.0 * far * near) / (far - near)
        m[3, 2] = -1.0
        self.matrix = m

    @classmethod
    def from_fov(cls, aspect: float, fovy: float, near: float, far: float) -> "Perspective":
        ymax = near * np.tan(fovy * 0.5)
        xmax = ymax * aspect
        return cls(-xmax, xmax, -ymax, ymax, near, far)

    def inverse(self) -> np.ndarray:
        """Analytic inverse (reference: src/geometry/frustum.rs:61-80)."""
        m = self.matrix
        inv = np.zeros((4, 4))
        inv[0, 0] = 1.0 / m[0, 0]
        inv[0, 3] = m[0, 2] / m[0, 0]
        inv[1, 1] = 1.0 / m[1, 1]
        inv[1, 3] = m[1, 2] / m[1, 1]
        inv[2, 3] = -1.0
        inv[3, 2] = 1.0 / m[2, 3]
        inv[3, 3] = m[2, 2] / m[2, 3]
        return inv


def transform_homogeneous(matrix: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Apply a 4x4 matrix to (N, 3) points with perspective division."""
    points = np.atleast_2d(points)
    q = points @ matrix[:3, :3].T + matrix[:3, 3]
    w = points @ matrix[3, :3].T + matrix[3, 3]
    return q / w[..., None]


_CLIP_CORNERS = (_CORNER_SIGNS * 2.0 - 1.0)[:, [0, 1, 2]]  # (-1|1)^3, x fastest


class Frustum:
    """A view frustum defined by its clip_from_query matrix."""

    def __init__(self, clip_from_query: np.ndarray,
                 query_from_clip: Optional[np.ndarray] = None) -> None:
        self.clip_from_query = np.asarray(clip_from_query, dtype=np.float64)
        if query_from_clip is None:
            query_from_clip = np.linalg.inv(self.clip_from_query)
        self.query_from_clip = query_from_clip

    @classmethod
    def new(cls, query_from_eye: Isometry, clip_from_eye: Perspective) -> "Frustum":
        clip_from_query = clip_from_eye.matrix @ query_from_eye.inverse().to_matrix4()
        query_from_clip = query_from_eye.to_matrix4() @ clip_from_eye.inverse()
        return cls(clip_from_query, query_from_clip)

    @classmethod
    def from_matrix4(cls, clip_from_query: np.ndarray) -> "Frustum":
        return cls(clip_from_query)

    def contains(self, points: np.ndarray) -> np.ndarray:
        clip = transform_homogeneous(self.clip_from_query, points)
        return np.all((clip > -1.0) & (clip < 1.0), axis=-1)

    def corners(self) -> np.ndarray:
        """World-space corners; order matches the reference (z fastest,
        then y, then x — src/geometry/frustum.rs:128-141)."""
        clip = np.array(
            [[x, y, z] for x in (-1.0, 1.0) for y in (-1.0, 1.0) for z in (-1.0, 1.0)]
        )
        return transform_homogeneous(self.query_from_clip, clip)

    def intersector(self) -> Intersector:
        c = self.corners()
        edges = normalize(
            np.stack(
                [
                    c[4] - c[0],  # x
                    c[2] - c[0],  # y
                    c[1] - c[0],  # z lower left
                    c[3] - c[2],  # z upper left
                    c[5] - c[4],  # z lower right
                    c[7] - c[6],  # z upper right
                ]
            )
        )
        face_normals = normalize(
            np.stack(
                [
                    np.cross(edges[0], edges[1]),  # front/back
                    np.cross(edges[0], edges[2]),  # lower
                    np.cross(edges[0], edges[3]),  # upper
                    np.cross(edges[1], edges[2]),  # left
                    np.cross(edges[1], edges[4]),  # right
                ]
            )
        )
        return Intersector(corners=c, edges=edges, face_normals=face_normals)
