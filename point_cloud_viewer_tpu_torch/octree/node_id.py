"""Octree NodeId algebra (copy of point_cloud_viewer_tpu/octree/node_id.py:
20-199, trimmed to what the builders, the octree, the web server and
octree/traversal.py call, and the public names of the original).

A NodeId packs an 8-bit level and a 120-bit base-8 path into a u128 (held as
a Python int for scalars, or as (level u8, path u64) array pairs for the
vectorized forms).  String form is 'r' + octal path digits.  The child bit
convention is (x > cx) << 2 | (y > cy) << 1 | (z > cz), i.e. x is the most
significant axis.  (Reference semantics: src/octree/node.rs:25-172.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..math.geometry import Cube

_PATH_MASK = (1 << 120) - 1


@dataclass(frozen=True, order=True)
class NodeId:
    """Immutable octree node identifier (value = level << 120 | path)."""

    value: int

    @classmethod
    def root(cls) -> "NodeId":
        return cls(0)

    @classmethod
    def from_level_index(cls, level: int, index: int) -> "NodeId":
        return cls((level << 120) | index)

    @classmethod
    def from_str(cls, name: str) -> "NodeId":
        if not name.startswith("r"):
            raise ValueError(f"invalid node name {name!r}")
        level = len(name) - 1
        index = int(name[1:], 8) if level > 0 else 0
        return cls.from_level_index(level, index)

    @property
    def level(self) -> int:
        return self.value >> 120

    @property
    def index(self) -> int:
        return self.value & _PATH_MASK

    def __str__(self) -> str:
        if self.level == 0:
            return "r"
        return "r" + format(self.index, "o").zfill(self.level)

    def child(self, child_index: int) -> "NodeId":
        assert 0 <= child_index < 8
        return NodeId.from_level_index(self.level + 1, (self.index << 3) + child_index)

    # node_id.py:68-83, unchanged.
    def parent(self) -> Optional["NodeId"]:
        if self.level == 0:
            return None
        return NodeId.from_level_index(self.level - 1, self.index >> 3)

    def child_index_in_parent(self) -> Optional[int]:
        if self.level == 0:
            return None
        return self.index & 7

    def ancestors(self) -> Iterator["NodeId"]:
        """Self, parent, ..., root."""
        node: Optional[NodeId] = self
        while node is not None:
            yield node
            node = node.parent()

    def find_bounding_cube(self, root: Cube) -> Cube:
        """Descend from the root cube along the path; floating-point
        semantics match the reference (min += bit * halved_edge at each
        level — src/octree/node.rs:157-172).  (node_id.py:85-98.)"""
        edge = root.edge_length
        mn = root.min.copy()
        for level in range(self.level - 1, -1, -1):
            edge /= 2.0
            child = (self.value >> (3 * level)) & 7
            mn = mn + edge * np.array(
                [(child >> 2) & 1, (child >> 1) & 1, child & 1], dtype=np.float64
            )
        return Cube(mn, edge)


# node_id.py:100-109, unchanged.
def child_index_from_cube(cube: Cube, points: np.ndarray) -> np.ndarray:
    """Vectorized ChildIndex::from_bounding_cube: (N, 3) points -> (N,) uint8
    with bit layout x<<2 | y<<1 | z and strict 'greater than center'
    comparisons (reference: src/octree/node.rs:34-42)."""
    gt = points > cube.center()
    return (
        gt[:, 0].astype(np.uint8) << 2
        | gt[:, 1].astype(np.uint8) << 1
        | gt[:, 2].astype(np.uint8)
    )


# ---------------------------------------------------------------------------
# Vectorized (array) forms.  Single-word u64 paths cover levels <= 21 (the
# builder's range — 63-bit Morton codes); two-word (hi, lo) u64 pairs cover
# the FORMAT's full range, level <= 40 with 120-bit paths
# (reference: src/octree/node.rs:52-56), so reference-built deep trees load.


# node_id.py:120-128, unchanged.
MAX_VECTOR_LEVEL = 21
MAX_FORMAT_LEVEL = 40  # 120-bit path / 3 bits per level


def pack_ids(levels: np.ndarray, paths: np.ndarray) -> list:
    """(K,) levels + (K,) uint64 paths -> list of NodeId."""
    return [
        NodeId.from_level_index(int(l), int(p)) for l, p in zip(levels, paths)
    ]


def unpack_ids(ids) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Iterable of NodeId -> (levels u8, path_hi u64, path_lo u64), where
    path = hi << 64 | lo.  Supports the full format range (level <= 40)."""
    levels = np.array([n.level for n in ids], dtype=np.uint8)
    if len(levels) and levels.max() > MAX_FORMAT_LEVEL:
        raise ValueError(
            f"node level exceeds the format maximum of {MAX_FORMAT_LEVEL}"
        )
    mask64 = (1 << 64) - 1
    lo = np.array([n.index & mask64 for n in ids], dtype=np.uint64)
    hi = np.array([n.index >> 64 for n in ids], dtype=np.uint64)
    return levels, hi, lo


# An id's value as two u64 words, as the native meta parser gives it: the
# upper word is the level byte over the path's top 56 bits (level << 56 |
# path_hi), the lower word the path's low 64 bits (path_lo).
_LEVEL_SHIFT = np.uint64(56)


def split_upper_words(id_hi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(K,) upper u64 words of ids -> (levels u8, path_hi u64)."""
    return ((id_hi >> _LEVEL_SHIFT).astype(np.uint8),
            id_hi & np.uint64((1 << 56) - 1))


def ids_at(levels: np.ndarray, path_hi: np.ndarray, path_lo: np.ndarray,
           rows) -> List[NodeId]:
    """The NodeIds of rows `rows` of the (levels, path_hi, path_lo) columns,
    in their order, in one pass: each column indexed once, the upper words
    joined in numpy and turned into Python ints with the lower words, and
    each NodeId made as its dataclass `__init__` makes it."""
    rows = np.asarray(rows, dtype=np.intp)
    upper = levels[rows].astype(np.uint64) << _LEVEL_SHIFT | path_hi[rows]
    new, set_field = object.__new__, object.__setattr__
    out = []
    for up, lo in zip(upper.tolist(), path_lo[rows].tolist()):
        node = new(NodeId)
        set_field(node, "value", up << 64 | lo)
        out.append(node)
    return out


def shifted_prefix(
    path_hi: np.ndarray, path_lo: np.ndarray, shift: np.ndarray
) -> np.ndarray:
    """(hi << 64 | lo) >> shift, low 64 bits, vectorized for shift in
    [0, 120]: the two-word right shift shared by cube descent and the
    coarse cull index."""
    shift = np.asarray(shift)
    ge = shift >= 64
    s_hi = np.where(ge, shift - 64, 0).astype(np.uint64)
    s_lo = np.where(ge, 0, shift).astype(np.uint64)
    carry_n = np.where(shift == 0, 0, 64 - shift).clip(min=0).astype(np.uint64)
    carry = np.where((shift > 0) & ~ge, path_hi << carry_n, np.uint64(0))
    return np.where(ge, path_hi >> s_hi, (path_lo >> s_lo) | carry)


def bounding_cubes(levels: np.ndarray, paths: np.ndarray, root: Cube):
    """Vectorized node cube descent over single-word u64 paths (levels <=
    21, the builder's range): returns (mins (K, 3) f64, edges (K,) f64).
    Floating-point semantics match the reference (min += bit * halved_edge
    at each level — src/octree/node.rs:157-172)."""
    return bounding_cubes2(
        levels, np.zeros(len(levels), dtype=np.uint64), paths, root
    )


def bounding_cubes2(
    levels: np.ndarray, path_hi: np.ndarray, path_lo: np.ndarray, root: Cube
):
    """Vectorized node cube descent over two-word (hi, lo) u64 paths —
    the format's full range (level <= 40, 120-bit paths)."""
    k = len(levels)
    mins = np.broadcast_to(root.min, (k, 3)).copy()
    edges = np.full(k, root.edge_length)
    levels = levels.astype(np.int64)
    path_hi = path_hi.astype(np.uint64)
    path_lo = path_lo.astype(np.uint64)
    max_level = int(levels.max()) if k else 0
    # Iterate global depth d = 1..max_level; a node participates while its
    # own level >= d. Child bits are taken from the path's top, root-first.
    for d in range(1, max_level + 1):
        active = levels >= d
        half = np.where(active, edges / 2.0, edges)
        shift = (3 * (levels - d)).clip(min=0)
        child = shifted_prefix(path_hi, path_lo, shift) & np.uint64(7)
        bits = np.stack(
            [(child >> np.uint64(2)) & np.uint64(1),
             (child >> np.uint64(1)) & np.uint64(1),
             child & np.uint64(1)],
            axis=1,
        ).astype(np.float64)
        mins = np.where(active[:, None], mins + bits * half[:, None], mins)
        edges = half
    return mins, edges
