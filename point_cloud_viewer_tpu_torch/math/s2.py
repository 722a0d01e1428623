"""S2 cell-ID geometry, implemented from scratch (no s2 library), vectorized.

The S2 scheme hashes unit-sphere directions into a 64-bit hierarchical id:
6 cube faces, each covered by a level-30 Hilbert curve over a quadratically
reprojected (u,v) grid.  This module provides the id algebra the framework
needs: point -> leaf cell, parent/level/ranges, tokens (the on-disk file
stems of S2 point clouds), child/parent navigation, and cell corner
geometry for culling.  Wire compatibility matters: ids and tokens must
match the s2geometry definition the reference's s2 crate implements
(reference usage: src/read_write/s2.rs, src/s2_cells/mod.rs).

All encode/decode paths are numpy-vectorized over (N,) id arrays; the
Hilbert traversal uses the standard 4-bit lookup tables.

Copy of point_cloud_viewer_tpu/math/s2.py:1-431, unchanged.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

MAX_LEVEL = 30
POS_BITS = 2 * MAX_LEVEL + 1  # 61
_LOOKUP_BITS = 4
_SWAP = 0x01
_INVERT = 0x02

_POS_TO_IJ = np.array(
    [[0, 1, 3, 2], [0, 2, 3, 1], [3, 2, 0, 1], [3, 1, 0, 2]], dtype=np.int64
)
_POS_TO_ORIENTATION = np.array([_SWAP, 0, 0, _INVERT | _SWAP], dtype=np.int64)


def _build_lookup_tables() -> Tuple[np.ndarray, np.ndarray]:
    lookup_pos = np.zeros(1 << (2 * _LOOKUP_BITS + 2), dtype=np.int64)
    lookup_ij = np.zeros(1 << (2 * _LOOKUP_BITS + 2), dtype=np.int64)

    def init(level, i, j, orig_orientation, pos, orientation):
        if level == _LOOKUP_BITS:
            ij = (i << _LOOKUP_BITS) + j
            lookup_pos[(ij << 2) + orig_orientation] = (pos << 2) + orientation
            lookup_ij[(pos << 2) + orig_orientation] = (ij << 2) + orientation
            return
        level += 1
        i <<= 1
        j <<= 1
        pos <<= 2
        r = _POS_TO_IJ[orientation]
        for index in range(4):
            init(
                level,
                i + (int(r[index]) >> 1),
                j + (int(r[index]) & 1),
                orig_orientation,
                pos + index,
                orientation ^ int(_POS_TO_ORIENTATION[index]),
            )

    for face_orientation in range(4):
        init(0, 0, 0, face_orientation, 0, face_orientation)
    return lookup_pos, lookup_ij


_LOOKUP_POS, _LOOKUP_IJ = _build_lookup_tables()


# ---------------------------------------------------------------------------
# Face / UV / ST projections (all vectorized)


def xyz_to_face_uv(points: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(N, 3) directions (any magnitude) -> (face (N,), u (N,), v (N,))."""
    p = np.asarray(points, dtype=np.float64)
    ax = np.abs(p)
    axis = np.argmax(ax, axis=-1)
    major = np.take_along_axis(p, axis[:, None], axis=1)[:, 0]
    face = np.where(major >= 0, axis, axis + 3)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    u = np.empty(len(p))
    v = np.empty(len(p))
    for f, (ue, ve) in enumerate(
        [
            (lambda: y / x, lambda: z / x),      # face 0 (+x)
            (lambda: -x / y, lambda: z / y),     # face 1 (+y)
            (lambda: -x / z, lambda: -y / z),    # face 2 (+z)
            (lambda: z / x, lambda: y / x),      # face 3 (-x)
            (lambda: z / y, lambda: -x / y),     # face 4 (-y)
            (lambda: -y / z, lambda: -x / z),    # face 5 (-z)
        ]
    ):
        m = face == f
        if m.any():
            with np.errstate(invalid="ignore", divide="ignore"):
                u[m] = ue()[m]
                v[m] = ve()[m]
    return face.astype(np.int64), u, v


def face_uv_to_xyz(face: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(face, u, v) -> un-normalized direction (N, 3)."""
    face = np.asarray(face)
    u = np.asarray(u, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    one = np.ones_like(u)
    outs = [
        np.stack([one, u, v], axis=-1),      # 0
        np.stack([-u, one, v], axis=-1),     # 1
        np.stack([-u, -v, one], axis=-1),    # 2
        np.stack([-one, -v, -u], axis=-1),   # 3
        np.stack([v, -one, -u], axis=-1),    # 4
        np.stack([v, u, -one], axis=-1),     # 5
    ]
    result = np.zeros((len(u), 3))
    for f in range(6):
        m = face == f
        if m.any():
            result[m] = outs[f][m]
    return result


def st_to_uv(s: np.ndarray) -> np.ndarray:
    """Quadratic ST -> UV reprojection (s2geometry's default)."""
    s = np.asarray(s, dtype=np.float64)
    return np.where(
        s >= 0.5, (1.0 / 3.0) * (4.0 * s * s - 1.0), (1.0 / 3.0) * (1.0 - 4.0 * (1.0 - s) * (1.0 - s))
    )


def uv_to_st(u: np.ndarray) -> np.ndarray:
    u = np.asarray(u, dtype=np.float64)
    pos = 0.5 * np.sqrt(np.maximum(1.0 + 3.0 * u, 0.0))
    neg = 1.0 - 0.5 * np.sqrt(np.maximum(1.0 - 3.0 * u, 0.0))
    return np.where(u >= 0.0, pos, neg)


def st_to_ij(s: np.ndarray) -> np.ndarray:
    return np.clip(
        np.floor(np.asarray(s) * (1 << MAX_LEVEL)), 0, (1 << MAX_LEVEL) - 1
    ).astype(np.int64)


# ---------------------------------------------------------------------------
# CellID core


def cell_id_from_face_ij(face: np.ndarray, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """Vectorized FromFaceIJ -> (N,) uint64 leaf cell ids."""
    face = np.asarray(face, dtype=np.int64)
    i = np.asarray(i, dtype=np.int64)
    j = np.asarray(j, dtype=np.int64)
    n = face.astype(np.uint64) << np.uint64(POS_BITS - 1)
    bits = face & _SWAP
    mask = (1 << _LOOKUP_BITS) - 1
    for k in range(7, -1, -1):
        bits += ((i >> (k * _LOOKUP_BITS)) & mask) << (_LOOKUP_BITS + 2)
        bits += ((j >> (k * _LOOKUP_BITS)) & mask) << 2
        bits = _LOOKUP_POS[bits]
        n |= (bits >> 2).astype(np.uint64) << np.uint64(k * 2 * _LOOKUP_BITS)
        bits &= _SWAP | _INVERT
    return n * np.uint64(2) + np.uint64(1)


def cell_id_to_face_ij(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized ToFaceIJ (orientation dropped) for LEAF positions of any
    cell id (uses the id's raw position bits)."""
    ids = np.asarray(ids, dtype=np.uint64)
    face = (ids >> np.uint64(POS_BITS)).astype(np.int64)
    bits = face & _SWAP
    i = np.zeros(len(ids), dtype=np.int64)
    j = np.zeros(len(ids), dtype=np.int64)
    for k in range(7, -1, -1):
        nbits = _LOOKUP_BITS if k < 7 else (MAX_LEVEL - 7 * _LOOKUP_BITS)  # 2 top bits
        pos_chunk = (
            (ids >> np.uint64(k * 2 * _LOOKUP_BITS + 1)).astype(np.int64)
            & ((1 << (2 * nbits)) - 1)
        )
        bits += pos_chunk << 2
        bits = _LOOKUP_IJ[bits]
        i += (bits >> (_LOOKUP_BITS + 2)) << (k * _LOOKUP_BITS)
        j += ((bits >> 2) & ((1 << _LOOKUP_BITS) - 1)) << (k * _LOOKUP_BITS)
        bits &= _SWAP | _INVERT
    return face, i, j


def leaf_cell_ids_from_points(points: np.ndarray) -> np.ndarray:
    """(N, 3) ECEF/direction vectors -> (N,) uint64 leaf (level 30) ids."""
    face, u, v = xyz_to_face_uv(points)
    i = st_to_ij(uv_to_st(u))
    j = st_to_ij(uv_to_st(v))
    return cell_id_from_face_ij(face, i, j)


# -- id algebra (vectorized; scalars work too through np broadcasting) ------


def lsb(ids: np.ndarray) -> np.ndarray:
    ids = np.asarray(ids, dtype=np.uint64)
    return ids & (~ids + np.uint64(1))


def lsb_for_level(level) -> np.uint64:
    return np.uint64(1) << np.uint64(2 * (MAX_LEVEL - np.asarray(level)))


def level_of(ids: np.ndarray) -> np.ndarray:
    """Level of each cell id (position of the trailing one bit)."""
    ids = np.asarray(ids, dtype=np.uint64)
    low = lsb(ids)
    # trailing-zero count via float trick is unsafe for u64; use log2 on the
    # exact power of two after splitting words.
    tz = np.zeros(ids.shape, dtype=np.int64)
    lo32 = (low & np.uint64(0xFFFFFFFF)).astype(np.int64)
    hi32 = (low >> np.uint64(32)).astype(np.int64)
    in_hi = lo32 == 0
    word = np.where(in_hi, hi32, lo32).astype(np.uint32)
    # 32-bit trailing zeros via de Bruijn-free approach: exact log2 of a
    # power of two is safe in f64.
    tz = np.log2(word.astype(np.float64)).astype(np.int64) + np.where(in_hi, 32, 0)
    return MAX_LEVEL - (tz >> 1)


def parent(ids: np.ndarray, level) -> np.ndarray:
    """Ancestor of each id at `level` (must be <= its own level)."""
    ids = np.asarray(ids, dtype=np.uint64)
    new_lsb = lsb_for_level(level)
    return (ids & (~new_lsb + np.uint64(1)) & ~(new_lsb - np.uint64(1))) | new_lsb


def range_min(ids: np.ndarray) -> np.ndarray:
    ids = np.asarray(ids, dtype=np.uint64)
    return ids - (lsb(ids) - np.uint64(1))


def range_max(ids: np.ndarray) -> np.ndarray:
    ids = np.asarray(ids, dtype=np.uint64)
    return ids + (lsb(ids) - np.uint64(1))


def contains(ancestors: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Elementwise: does ancestors[k] contain ids[k]?"""
    return (range_min(ancestors) <= np.asarray(ids, dtype=np.uint64)) & (
        np.asarray(ids, dtype=np.uint64) <= range_max(ancestors)
    )


def children(cell_id: int) -> list:
    """The 4 children of a scalar cell id: id + (2k-3) * (lsb >> 2)."""
    cid = np.uint64(cell_id)
    l = lsb(cid)
    if l == np.uint64(1):
        raise ValueError("leaf cell has no children")
    lc = l >> np.uint64(2)
    base = cid - np.uint64(3) * lc
    return [np.uint64(base + np.uint64(2 * k) * lc) for k in range(4)]


# -- tokens ------------------------------------------------------------------


def token(cell_id: int) -> str:
    """Hex token: 16 nibbles with trailing zeros stripped ('X' for id 0)."""
    cid = int(cell_id)
    if cid == 0:
        return "X"
    s = format(cid, "016x")
    return s.rstrip("0")


def token_to_id(tok: str) -> int:
    if tok in ("X", "x", ""):
        return 0
    return int(tok.ljust(16, "0"), 16)


# -- cell geometry -----------------------------------------------------------


def cell_corners_xyz(ids: np.ndarray) -> np.ndarray:
    """(K,) ids -> (K, 4, 3) unit-sphere corner directions of each cell."""
    ids = np.asarray(ids, dtype=np.uint64)
    face, i, j = cell_id_to_face_ij(ids)
    level = level_of(ids)
    size = np.int64(1) << (MAX_LEVEL - level)  # leaf cells per side
    i0 = (i >> (MAX_LEVEL - level)) << (MAX_LEVEL - level)
    j0 = (j >> (MAX_LEVEL - level)) << (MAX_LEVEL - level)
    scale = 1.0 / (1 << MAX_LEVEL)
    corners = []
    for di, dj in ((0, 0), (1, 0), (1, 1), (0, 1)):
        s = (i0 + di * size) * scale
        t = (j0 + dj * size) * scale
        u = st_to_uv(s)
        v = st_to_uv(t)
        xyz = face_uv_to_xyz(face, u, v)
        xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
        corners.append(xyz)
    return np.stack(corners, axis=1)


def average_area_steradians(level: int) -> float:
    """Average cell area at a level (4*pi/6 / 4^level per face cell)."""
    return (4.0 * np.pi / 6.0) / (4.0 ** level)


# ---------------------------------------------------------------------------
# Lat/lng rect covering — the reference's query->cell selection heuristic
# (src/s2_cells/mod.rs:219-233: corner cells -> CellUnion -> rect_bound ->
# rect.intersects_cell).  Conservative on both sides: the query rect is
# padded for great-circle bulge, cell rects for edge bulge; degenerate
# cases (pole proximity, wide longitude spans) widen to the full interval.


def latlng_of(points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 3) ECEF -> (lat, lng) radians."""
    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    norm = np.linalg.norm(points, axis=1)
    lat = np.arcsin(np.clip(points[:, 2] / np.maximum(norm, 1e-300), -1.0, 1.0))
    lng = np.arctan2(points[:, 1], points[:, 0])
    return lat, lng


def _min_lng_interval(lngs: np.ndarray) -> Tuple[float, float, float]:
    """Minimal CCW interval [lo, hi] (may wrap) covering all lngs; returns
    (lo, hi, span)."""
    ls = np.sort(np.asarray(lngs, dtype=np.float64))
    gaps = np.diff(np.concatenate([ls, ls[:1] + 2.0 * np.pi]))
    g = int(np.argmax(gaps))
    span = 2.0 * np.pi - gaps[g]
    lo = float(ls[(g + 1) % len(ls)])
    hi = float(ls[g])
    return lo, hi, float(span)


class LatLngRect:
    """A latitude band x (possibly wrapping) longitude interval."""

    FULL_LNG_SPAN = 2.0 * np.pi

    def __init__(self, lat_lo: float, lat_hi: float, lng_lo: float,
                 lng_hi: float, full_lng: bool = False) -> None:
        self.lat_lo = lat_lo
        self.lat_hi = lat_hi
        self.lng_lo = lng_lo
        self.lng_hi = lng_hi
        self.full_lng = full_lng

    @classmethod
    def from_points(cls, points: np.ndarray) -> "LatLngRect":
        """Conservative rect bound of a convex region given its corners:
        lat padded by the great-circle bulge of the widest chord, full
        longitude when the span is too wide to bound safely."""
        lat, lng = latlng_of(points)
        lat_lo, lat_hi = float(lat.min()), float(lat.max())
        lo, hi, span = _min_lng_interval(lng)
        if span > np.pi / 2:
            return cls(-np.pi / 2, np.pi / 2, -np.pi, np.pi, full_lng=True)
        max_abs = max(abs(lat_lo), abs(lat_hi))
        if max_abs > 1.45:  # within ~7deg of a pole: give up on tightness
            return cls(-np.pi / 2, np.pi / 2, -np.pi, np.pi, full_lng=True)
        # EXACT poleward bound for any point of the convex hull: for
        # p = sum w_i c_i,  tan(lat(p)) = z(p) / h(p) where h is the
        # horizontal norm.  z is linear, and with all horizontal
        # projections within span/2 of the interval bisector,
        # h(p) >= cos(span/2) * sum w_i h_i, so by the mediant inequality
        #   tan(lat(p)) <= max_i tan(lat_i) / cos(span/2).
        # (Toward the equator no pad is needed: shrinking h pushes a
        # southern z further south, and vice versa.)
        inv_cos = 1.0 / np.cos(span / 2.0)
        pad_hi = (
            np.arctan(np.tan(lat_hi) * inv_cos) - lat_hi if lat_hi > 0 else 0.0
        )
        pad_lo = (
            lat_lo - np.arctan(np.tan(lat_lo) * inv_cos) if lat_lo < 0 else 0.0
        )
        eps = 1e-9
        return cls(
            max(lat_lo - pad_lo - eps, -np.pi / 2),
            min(lat_hi + pad_hi + eps, np.pi / 2),
            lo, hi,
        )

    def _lng_overlaps(self, lo: np.ndarray, hi: np.ndarray,
                      full: np.ndarray) -> np.ndarray:
        """Does [self.lng_lo, self.lng_hi] (CCW, wrapping) overlap each
        [lo, hi] (CCW, wrapping)?"""
        if self.full_lng:
            return np.ones(len(lo), dtype=bool)
        two_pi = 2.0 * np.pi
        # Express everything as offsets from self.lng_lo in [0, 2pi).
        a_hi = (self.lng_hi - self.lng_lo) % two_pi
        b_lo = (lo - self.lng_lo) % two_pi
        b_hi = (hi - self.lng_lo) % two_pi
        wraps = b_hi < b_lo  # other interval crosses self.lng_lo
        overlap = (b_lo <= a_hi) | wraps | (b_hi <= a_hi)
        return overlap | full

    def intersects_cells(self, ids: np.ndarray) -> np.ndarray:
        """(K,) cell ids -> (K,) bool, conservative."""
        ids = np.asarray(ids, dtype=np.uint64)
        if len(ids) == 0:
            return np.zeros(0, dtype=bool)
        corners = cell_corners_xyz(ids)  # (K, 4, 3)
        lat, lng = latlng_of(corners.reshape(-1, 3))
        lat = lat.reshape(-1, 4)
        lng = lng.reshape(-1, 4)
        level = level_of(ids).astype(np.float64)
        edge = np.minimum(1.8 * np.exp2(-level), np.pi)  # max edge angle
        cell_lat_lo = lat.min(axis=1) - edge
        cell_lat_hi = lat.max(axis=1) + edge
        lat_overlap = (cell_lat_lo <= self.lat_hi) & (cell_lat_hi >= self.lat_lo)

        # Cell lng interval: minimal covering interval of the 4 corners,
        # padded by the edge angle; wide/polar cells widen to full.
        # Vectorized over cells (the 278k-cell containers of the query path
        # would otherwise pay seconds of Python loop per wide query): sort
        # the (K, 4) corner lngs per row, find the largest circular gap —
        # its complement is the minimal covering interval.
        k = len(ids)
        two_pi = 2.0 * np.pi
        ls = np.sort(lng, axis=1)  # (K, 4)
        gaps = np.diff(np.concatenate([ls, ls[:, :1] + two_pi], axis=1), axis=1)
        g = np.argmax(gaps, axis=1)  # (K,)
        rows = np.arange(k)
        span = two_pi - gaps[rows, g]
        full = (
            (span + 2 * edge > np.pi)
            | (cell_lat_hi >= np.pi / 2 - 1e-9)
            | (cell_lat_lo <= -np.pi / 2 + 1e-9)
        )
        lo = np.where(full, -np.pi, ls[rows, (g + 1) % 4] - edge)
        hi = np.where(full, np.pi, ls[rows, g] + edge)
        return lat_overlap & self._lng_overlaps(lo, hi, full)
