"""The viewer's node selection for one camera matrix, in NumPy float64:
which nodes a frustum sees (the separating-axis test of each node's cube
against the frustum), each one's size on screen, and the list the viewer
draws from, largest first and capped.

Rules (the upstream viewer's octree culling, src/octree/mod.rs):
- the frustum is the matrix's clip cube [-1, 1]^3 mapped back to the world;
- a node is out when some axis separates its cube from the frustum: the
  cube's 3 face normals, the frustum's face normals, and the cross products
  of the cube's 3 edge directions with the frustum's edge directions;
- its size on screen is the area of the box around its 8 corners in
  normalised device x, y, each clamped to [-1, 1];
- visible nodes that hold points are listed by size, largest first (ties
  in table order), and the list is cut at `cap` nodes;
- a node's margin is how deep its cube reaches into the frustum along the
  axis where it reaches least (negative: how far it lies out), so a node
  whose margin is within rounding of 0 touches the frustum's boundary and
  may fall on either side in another precision.

`dtype` is the precision of the node table, matrix and projections:
float64 for the reference, bfloat16 for the control."""

from __future__ import annotations

import numpy as np
import torch

# Unit cube corners, x fastest.
_UNIT = np.array([[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)],
                 dtype=np.float64)


def _frustum_axes(matrix: np.ndarray) -> tuple:
    inv = np.linalg.inv(matrix)
    ndc = np.array([[x, y, z, 1.0] for x in (-1.0, 1.0) for y in (-1.0, 1.0)
                    for z in (-1.0, 1.0)])
    h = ndc @ inv.T
    corners = h[:, :3] / h[:, 3:4]  # index 4x + 2y + z over {-1, 1}
    c = corners
    edges = [c[4] - c[0], c[2] - c[0], c[1] - c[0], c[3] - c[2], c[5] - c[4],
             c[7] - c[6]]
    faces = [(0, 1, 2), (4, 6, 5), (0, 4, 1), (2, 3, 6), (0, 2, 4), (1, 5, 3)]
    normals = [np.cross(c[b] - c[a], c[d] - c[a]) for a, b, d in faces]
    unit = np.eye(3)
    cross = [np.cross(u, e) for u in unit for e in edges]
    axes = np.array([*unit, *normals, *cross])
    norm = np.linalg.norm(axes, axis=1)
    axes = axes[norm > 1e-12 * norm.max()]
    axes /= np.linalg.norm(axes, axis=1)[:, None]
    proj = corners @ axes.T
    return axes, proj.min(0), proj.max(0)


def select(matrix: np.ndarray, node_min: np.ndarray, node_edge: np.ndarray,
           num_points: np.ndarray, cap: int, dtype=torch.float64) -> tuple:
    """-> (ids: table indices in draw order, capped; sizes (K,) of every
    node; visible (K,) bool; margin (K,) in world units)."""
    axes, qmin, qmax = _frustum_axes(np.asarray(matrix, dtype=np.float64))
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64)).to(dtype)  # noqa: E731
    corners = t(node_min)[:, None, :] + t(_UNIT)[None] * t(node_edge)[:, None, None]
    proj = corners @ t(axes).T  # (K, 8, A)
    depth = torch.minimum(proj.amax(1) - t(qmin), t(qmax) - proj.amin(1))
    out = ((proj.amin(1) > t(qmax)) | (proj.amax(1) < t(qmin))).any(1)
    m = t(matrix)
    w = corners @ m[3, :3] + m[3, 3]
    x = ((corners @ m[0, :3] + m[0, 3]) / w).clamp(-1.0, 1.0)
    y = ((corners @ m[1, :3] + m[1, 3]) / w).clamp(-1.0, 1.0)
    sizes = ((x.amax(1) - x.amin(1)) * (y.amax(1) - y.amin(1))).double().numpy()
    visible = (~out).numpy() & (np.asarray(num_points) > 0)
    priority = np.where(visible, sizes, -np.inf)
    order = np.argsort(-priority, kind="stable")
    margin = depth.amin(1).double().numpy()
    return order[:min(int(visible.sum()), cap)], sizes, visible, margin
