"""Octree traversal utilities.

The vectorized paths (octree.Octree) handle the hot queries; this module
keeps the generic BFS-with-predicate iterator for host-side tooling
(reference: src/octree/octree_iterator.rs:4-44).

Copy of point_cloud_viewer_tpu/octree/traversal.py:1-32, unchanged.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterator, Set

from .node_id import NodeId


def node_ids_bfs(
    octree, predicate: Callable[[NodeId], bool] = lambda _: True
) -> Iterator[NodeId]:
    """Breadth-first iteration over the octree's existing nodes, descending
    only into nodes matching `predicate`."""
    existing: Set[int] = {n.value for n in octree.node_ids}
    if NodeId.root().value not in existing:
        return
    queue = deque([NodeId.root()])
    while queue:
        node = queue.popleft()
        if not predicate(node):
            continue
        yield node
        for i in range(8):
            child = node.child(i)
            if child.value in existing:
                queue.append(child)
