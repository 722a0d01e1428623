"""2D quadtree node algebra for X-ray map tiles (reference: quadtree crate).

QuadNodeId packs (level, base-4 path); string form 'r' + quaternary digits.
Child bit convention: x<<1 | y (x east, y north).  SpatialNodeId is the
(level, x, y) tile address; conversions follow the Bing quadkey scheme
(quadtree/src/lib.rs:266-349).

Copy of point_cloud_viewer_tpu/xray/quadtree.py:1-162, unchanged.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class Rect:
    """Axis-aligned square in the xy plane."""

    min_x: float
    min_y: float
    edge_length: float

    @property
    def max_x(self) -> float:
        return self.min_x + self.edge_length

    @property
    def max_y(self) -> float:
        return self.min_y + self.edge_length

    def center(self) -> Tuple[float, float]:
        return (self.min_x + self.edge_length / 2.0, self.min_y + self.edge_length / 2.0)


class Direction(enum.Enum):
    LEFT = (-1, 0)
    TOP_LEFT = (-1, 1)
    TOP = (0, 1)
    TOP_RIGHT = (1, 1)
    RIGHT = (1, 0)
    BOTTOM_RIGHT = (1, -1)
    BOTTOM = (0, -1)
    BOTTOM_LEFT = (-1, -1)

    def opposite(self) -> "Direction":
        dx, dy = self.value
        return Direction((-dx, -dy))


@dataclass(frozen=True, order=True)
class QuadNodeId:
    level: int
    index: int

    @classmethod
    def root(cls) -> "QuadNodeId":
        return cls(0, 0)

    @classmethod
    def from_str(cls, name: str) -> "QuadNodeId":
        if not name.startswith("r"):
            raise ValueError(f"invalid quadtree node name {name!r}")
        level = len(name) - 1
        index = int(name[1:], 4) if level > 0 else 0
        return cls(level, index)

    def __str__(self) -> str:
        if self.level == 0:
            return "r"
        digits = [
            str((self.index >> (2 * l)) & 3) for l in range(self.level - 1, -1, -1)
        ]
        return "r" + "".join(digits)

    def child(self, child_index: int) -> "QuadNodeId":
        assert 0 <= child_index < 4
        return QuadNodeId(self.level + 1, (self.index << 2) + child_index)

    def parent(self) -> Optional["QuadNodeId"]:
        if self.level == 0:
            return None
        return QuadNodeId(self.level - 1, self.index >> 2)

    def child_index_in_parent(self) -> Optional[int]:
        if self.level == 0:
            return None
        return self.index & 3

    # -- spatial form --------------------------------------------------------

    def to_spatial(self) -> "SpatialNodeId":
        x = y = 0
        for i in range(1, self.level + 1):
            mask = 1 << (self.level - i)
            chunk = self.index >> ((self.level - i) * 2)
            if chunk & 0b01:
                y |= mask
            if chunk & 0b10:
                x |= mask
        return SpatialNodeId(self.level, x, y)

    def neighbor(self, direction: Direction) -> Optional["QuadNodeId"]:
        s = self.to_spatial().neighbor(direction)
        return s.to_node_id() if s is not None else None

    def find_bounding_rect(self, root_rect: Rect) -> Rect:
        edge = root_rect.edge_length
        mx, my = root_rect.min_x, root_rect.min_y
        for l in range(self.level - 1, -1, -1):
            edge /= 2.0
            child = (self.index >> (2 * l)) & 3
            if child & 0b10:
                mx += edge
            if child & 0b01:
                my += edge
        return Rect(mx, my, edge)


@dataclass(frozen=True)
class SpatialNodeId:
    level: int
    x: int
    y: int

    def neighbor(self, direction: Direction) -> Optional["SpatialNodeId"]:
        dx, dy = direction.value
        x, y = self.x + dx, self.y + dy
        max_dim = 1 << self.level
        if 0 <= x < max_dim and 0 <= y < max_dim:
            return SpatialNodeId(self.level, x, y)
        return None

    def to_node_id(self) -> QuadNodeId:
        index = 0
        for i in range(1, self.level + 1):
            index <<= 2
            mask = 1 << (self.level - i)
            if self.y & mask:
                index += 0b01
            if self.x & mask:
                index += 0b10
        return QuadNodeId(self.level, index)


def nodes_at_level(root: QuadNodeId, level: int) -> List[QuadNodeId]:
    """All descendants of `root` at `level` (reference:
    xray/src/generation.rs:683-699)."""
    nodes = [root]
    for _ in range(level - root.level):
        nodes = [n.child(i) for n in nodes for i in range(4)]
    return nodes


def node_rects(ids: List[QuadNodeId], root_rect: Rect) -> np.ndarray:
    """Vectorized bounding rects: (K, 3) columns [min_x, min_y, edge]."""
    out = np.empty((len(ids), 3))
    for k, nid in enumerate(ids):
        r = nid.find_bounding_rect(root_rect)
        out[k] = (r.min_x, r.min_y, r.edge_length)
    return out
