"""S2 leaf cell ids of points and the id algebra a cell union needs: a
frozen copy of the program's math/s2.py (the Hilbert lookup tables,
xyz_to_face_uv, uv_to_st, st_to_ij, cell_id_from_face_ij and the
range functions), which follows the s2geometry definition."""

from __future__ import annotations

import numpy as np

MAX_LEVEL = 30
POS_BITS = 2 * MAX_LEVEL + 1
_LOOKUP_BITS = 4
_SWAP = 0x01
_INVERT = 0x02
_POS_TO_IJ = np.array([[0, 1, 3, 2], [0, 2, 3, 1], [3, 2, 0, 1], [3, 1, 0, 2]],
                      dtype=np.int64)
_POS_TO_ORIENTATION = np.array([_SWAP, 0, 0, _INVERT | _SWAP], dtype=np.int64)


def _lookup_pos() -> np.ndarray:
    table = np.zeros(1 << (2 * _LOOKUP_BITS + 2), dtype=np.int64)

    def init(level, i, j, orig, pos, orientation):
        if level == _LOOKUP_BITS:
            table[(((i << _LOOKUP_BITS) + j) << 2) + orig] = (
                (pos << 2) + orientation)
            return
        r = _POS_TO_IJ[orientation]
        for index in range(4):
            init(level + 1, (i << 1) + (int(r[index]) >> 1),
                 (j << 1) + (int(r[index]) & 1), orig, (pos << 2) + index,
                 orientation ^ int(_POS_TO_ORIENTATION[index]))

    for orientation in range(4):
        init(0, 0, 0, orientation, 0, orientation)
    return table


_LOOKUP_POS = _lookup_pos()


def _face_uv(p: np.ndarray) -> tuple:
    axis = np.argmax(np.abs(p), axis=-1)
    major = np.take_along_axis(p, axis[:, None], axis=1)[:, 0]
    face = np.where(major >= 0, axis, axis + 3)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    u = np.empty(len(p))
    v = np.empty(len(p))
    with np.errstate(invalid="ignore", divide="ignore"):
        for f, (uf, vf) in enumerate(((y / x, z / x), (-x / y, z / y),
                                      (-x / z, -y / z), (z / x, y / x),
                                      (z / y, -x / y), (-y / z, -x / z))):
            m = face == f
            u[m] = uf[m]
            v[m] = vf[m]
    return face.astype(np.int64), u, v


def _uv_to_st(u: np.ndarray) -> np.ndarray:
    pos = 0.5 * np.sqrt(np.maximum(1.0 + 3.0 * u, 0.0))
    neg = 1.0 - 0.5 * np.sqrt(np.maximum(1.0 - 3.0 * u, 0.0))
    return np.where(u >= 0.0, pos, neg)


def _st_to_ij(s: np.ndarray) -> np.ndarray:
    return np.clip(np.floor(s * (1 << MAX_LEVEL)), 0,
                   (1 << MAX_LEVEL) - 1).astype(np.int64)


def leaf_ids(points: np.ndarray) -> np.ndarray:
    """(N, 3) ECEF points -> (N,) uint64 level-30 cell ids."""
    face, u, v = _face_uv(np.asarray(points, dtype=np.float64))
    i, j = _st_to_ij(_uv_to_st(u)), _st_to_ij(_uv_to_st(v))
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


def lsb_for_level(level: int) -> int:
    return 1 << (2 * (MAX_LEVEL - level))


def parent(leaf: int, level: int) -> int:
    low = lsb_for_level(level)
    return (int(leaf) & (~(low - 1) & ~low & ((1 << 64) - 1))) | low


def range_min(cell: int) -> int:
    low = int(cell) & -int(cell)
    return int(cell) - (low - 1)


def range_max(cell: int) -> int:
    low = int(cell) & -int(cell)
    return int(cell) + (low - 1)


def union_contains(cells, leaves: np.ndarray) -> np.ndarray:
    """(N,) leaf ids -> (N,) bool: inside one of the cells."""
    out = np.zeros(len(leaves), dtype=bool)
    for c in cells:
        out |= ((leaves >= np.uint64(range_min(c)))
                & (leaves <= np.uint64(range_max(c))))
    return out
