"""The viewer's per-frame frustum cull + LOD selection over every octree
node (port of point_cloud_viewer_tpu/ops/culling.py).

Each frame: the host derives the frustum's separating axes and the query
corners' projections (numpy, copied below), the node table stays on the
device, and one K5 launch (ops/cull_cuda.py) gives every node's screen
size and visibility; a stable `torch.sort` of -priority orders the nodes
(largest on screen first, invisible ones last, ties in index order as
`jnp.argsort`).  On CPU tensors the same calls run K5's plain version.

Frustum, Isometry and Perspective are the port's host geometry
(math/geometry.py), re-exported here for the callers of the session.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..math.geometry import Frustum, Isometry, Perspective  # noqa: F401 (re-exported)
from ..utils.progress import count, span
from .cull_cuda import cull_lod

# --- copied from point_cloud_viewer_tpu/ops/culling.py:19-26 --------------

REL_IN = 0
REL_CROSS = 1
REL_OUT = 2

# Unit cube corners, x fastest (matches octree.octree._CORNER_UNIT).
_CORNER_UNIT = np.array(
    [[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)], dtype=np.float32
)


# --- the cull's building blocks (culling.py:29-60) -------------------------
#
# In the JAX package these are jnp (no Pallas); here they are plain torch
# on the device their inputs are on, beside K5 (cull_cuda.cull_lod), which
# fuses them for the viewer.  Each 3-term projection is one chain of
# elementwise ops in a fixed order (`_dot3`), so the card and the CPU give
# the same bits (no matmul, so no TF32 and no blocking of its sums).


def _dot3(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_d v[..., d] * w[d] for d = 0, 1, 2 (w's components broadcast
    against v's leading dims), summed as XLA:CPU sums jnp.einsum's
    3-term dot: fma(v2, w2, fma(v1, w1, v0 * w0)).  Each fused
    multiply-add is an f64 product (exact for f32 factors) plus an f64
    add, rounded once to v's dtype: that is the f32 fma but where the f64
    sum itself rounds onto an f32 halfway point (double rounding).  f64
    inputs take a plain multiply-add chain."""
    acc = v[..., 0] * w[0]
    for d in (1, 2):
        acc = (v[..., d].double() * w[d].double() + acc).to(v.dtype)
    return acc


def node_corners(mins: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(K, 3) mins + (K,) edges -> (K, 8, 3) cube corners."""
    unit = torch.as_tensor(_CORNER_UNIT, dtype=mins.dtype, device=mins.device)
    return mins[:, None, :] + unit[None, :, :] * edges[:, None, None]


def sat_relation_device(
    axes: torch.Tensor,  # (A, 3) separating axes
    query_min_proj: torch.Tensor,  # (A,) query corners' min projection
    query_max_proj: torch.Tensor,  # (A,)
    corners: torch.Tensor,  # (K, 8, 3)
) -> torch.Tensor:
    """Batched SAT relations (K,) int8: 0=In, 1=Cross, 2=Out."""
    proj = _dot3(corners[:, :, None, :], axes.T)  # (K, 8, A)
    b_min = proj.amin(dim=1)
    b_max = proj.amax(dim=1)
    out = ((b_min > query_max_proj) | (b_max < query_min_proj)).any(dim=1)
    cross = ((query_min_proj > b_min) | (b_max > query_max_proj)).any(dim=1)
    rel = torch.where(cross, REL_CROSS, REL_IN)
    return torch.where(out, REL_OUT, rel).to(torch.int8)


def relative_sizes_on_screen_device(
    matrix: torch.Tensor, corners: torch.Tensor
) -> torch.Tensor:
    """Projected screen-size heuristic (K,), the hemicube-clamped xy area of
    the projected cube (reference: src/octree/mod.rs:119-139)."""
    w = _dot3(corners, matrix[3, :3]) + matrix[3, 3]
    x, y = ((_dot3(corners, matrix[r, :3]) + matrix[r, 3]) / w
            for r in (0, 1))
    x = x.clamp(-1.0, 1.0)
    y = y.clamp(-1.0, 1.0)
    return (x.amax(dim=1) - x.amin(dim=1)) * (y.amax(dim=1) - y.amin(dim=1))


# --- the device step (culling.py:63-97) ------------------------------------


def _order(priority: torch.Tensor) -> torch.Tensor:
    """Indices by descending priority along the last dim, stable: the
    order of jnp.argsort(-priority) (NaN last in both)."""
    return torch.sort(-priority, dim=-1, stable=True).indices.to(torch.int32)


def frustum_cull_lod_select(
    matrix: torch.Tensor,  # (4, 4) clip_from_query, or (F, 4, 4)
    axes: torch.Tensor,  # (A, 3) cached separating axes, or (F, A, 3)
    query_min_proj: torch.Tensor,  # (A,), or (F, A)
    query_max_proj: torch.Tensor,  # (A,), or (F, A)
    node_mins: torch.Tensor,  # (K, 3)
    node_edges: torch.Tensor,  # (K,)
    num_points: torch.Tensor,  # (K,) int32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-frame step: returns (priority_order (K,) int32, sizes (K,),
    visible (K,) bool) on the inputs' device.  priority_order lists ALL
    node indices sorted by descending screen size with invisible nodes
    pushed to the end; callers take the first `visible.sum()` entries.
    With a leading frame dim F on the frame's inputs, the F frames take
    one K5 launch and each output gains that dim: (F, K)."""
    sizes, visible, priority = cull_lod(
        matrix, axes, query_min_proj, query_max_proj, node_mins, node_edges,
        num_points,
    )
    return _order(priority), sizes, visible


# The JAX package's multi-frame name: the same function on (F, ...) inputs.
frustum_cull_lod_select_frames = frustum_cull_lod_select


# --- copied from point_cloud_viewer_tpu/ops/culling.py:100-186 -------------


def frustum_cull_lod_select_host(
    matrix: np.ndarray,
    axes: np.ndarray,
    query_min_proj: np.ndarray,
    query_max_proj: np.ndarray,
    node_mins: np.ndarray,
    node_edges: np.ndarray,
    num_points: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host twin of frustum_cull_lod_select (same SAT + screen-size rules,
    native C++ kernel with a numpy fallback), on numpy arrays."""
    from .. import native

    out = native.cull_lod_select(
        matrix, axes, query_min_proj, query_max_proj,
        node_mins, node_edges, num_points,
    )
    if out is not None:
        return out
    # numpy fallback (same math as the device kernel, host-resident)
    mins = np.asarray(node_mins, dtype=np.float32)
    edges = np.asarray(node_edges, dtype=np.float32)
    corners = mins[:, None, :] + _CORNER_UNIT[None, :, :] * edges[:, None, None]
    proj = np.einsum("kcd,ad->kca", corners, np.asarray(axes, np.float32))
    b_min, b_max = proj.min(axis=1), proj.max(axis=1)
    out_mask = np.any(
        (b_min > query_max_proj) | (b_max < query_min_proj), axis=1
    )
    m = np.asarray(matrix, dtype=np.float32)
    q = np.einsum("kcd,rd->kcr", corners, m[:3, :3]) + m[:3, 3]
    w = np.einsum("kcd,d->kc", corners, m[3, :3]) + m[3, 3]
    p = q / w[..., None]
    x = np.clip(p[..., 0], -1.0, 1.0)
    y = np.clip(p[..., 1], -1.0, 1.0)
    sizes = (x.max(axis=1) - x.min(axis=1)) * (y.max(axis=1) - y.min(axis=1))
    visible = (~out_mask) & (np.asarray(num_points) > 0)
    priority = np.where(visible, sizes, -np.inf)
    order = np.argsort(-priority, kind="stable").astype(np.int32)
    return order, sizes.astype(np.float32), visible


def frustum_axes_and_projections(frustum, origin=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side per-frame prep: cached separating axes of the frustum vs
    AABBs plus the query-corner projections (A is data-dependent; computed
    once per frame, tiny).  With an f64 `origin`, the projections are
    those of the frame whose zero is `origin` (each shifted by
    axes . origin in f64 before the cast); the axes are the same."""
    cached = frustum.intersector().cached_axes_for_aabb()
    proj = cached.corners @ cached.axes.T  # (8, A)
    qmin, qmax = proj.min(axis=0), proj.max(axis=0)
    if origin is not None:
        shift = cached.axes @ origin
        qmin, qmax = qmin - shift, qmax - shift
    return (
        cached.axes.astype(np.float32),
        qmin.astype(np.float32),
        qmax.astype(np.float32),
    )


def local_clip_matrix(clip_from_query: np.ndarray, origin=None) -> np.ndarray:
    """The frame's f32 clip_from_query; with an f64 `origin`, that of the
    frame whose zero is `origin`: clip_from_query @ T(origin), composed in
    f64 before the cast."""
    m = np.asarray(clip_from_query, dtype=np.float64)
    if origin is not None:
        m = m.copy()
        m[:, 3] = m[:, :3] @ origin + m[:, 3]
    return m.astype(np.float32)


def pad_cull_axes(axes, qmin, qmax, a_cap: int):
    """Pad a frame's SAT axes to width a_cap with inert sentinels: a zero
    axis projects everything to 0, which the [-inf, inf] query range never
    separates, so relations are unchanged."""
    a = len(axes)
    ax = np.zeros((a_cap, 3), np.float32)
    qn = np.full(a_cap, -np.inf, np.float32)
    qx = np.full(a_cap, np.inf, np.float32)
    ax[:a] = axes
    qn[:a] = qmin
    qx[:a] = qmax
    return ax, qn, qx


def prep_frustum_frames(frustums, axis_capacity: int = 0, origin=None):
    """Host prep for a multi-frame cull dispatch: per-frame cached axes
    padded to a common width (>= axis_capacity), stacked into (F, 4, 4)
    matrices + (F, A, 3)/(F, A)/(F, A) axis arrays, in the frame whose
    zero is `origin` where one is given."""
    prep = [frustum_axes_and_projections(f, origin) for f in frustums]
    a_cap = max([int(axis_capacity)] + [len(p[0]) for p in prep])
    return _stack_frames(frustums, prep, a_cap, origin)


def _stack_frames(frustums, prep, a_cap: int, origin=None):
    """prep_frustum_frames' stacks from each frame's
    frustum_axes_and_projections, padded to a_cap."""
    padded = [pad_cull_axes(*p, a_cap) for p in prep]
    mats = [local_clip_matrix(f.clip_from_query, origin) for f in frustums]
    return (np.stack(mats),) + tuple(np.stack(col) for col in zip(*padded))


# --- the session (culling.py:189-259) --------------------------------------


class DeviceCullSession:
    """Device-resident cull + LOD selection across frames.

    The node table (mins/edges/num_points) is uploaded ONCE to `device` as
    f32/f32/int32, as the JAX session does (so an f64 octree table is cut
    to f32 here too); each frame ships only a 4x4 matrix and `a_cap`
    padded SAT axes (zero axes with an infinite query range never
    separate).  `a_cap` starts at `axis_capacity` and grows to twice a
    frustum's axis count when one needs more.  `step` is one K5 launch per
    frame, `step_frames` one launch for F frames; both fetch (order,
    sizes, visible) to numpy, which synchronises on the device's default
    stream, so the session can run in a worker thread.  `step_capped`
    is `step` cut on the device to the first `cap` entries of its order:
    it fetches those entries, their sizes and the count of visible nodes,
    one copy of at most 8 B a listed node, where `step` fetches 9 B a node
    of the table.

    With an f64 `origin` the session culls in the frame whose zero is
    `origin`: the table is `node_mins - origin` in f64 before the f32 cut,
    and each frame's matrix and projections are moved to it in f64 before
    theirs (`local_clip_matrix`, `frustum_axes_and_projections`).  A table
    in ECEF (~5e6 m, where an f32 ulp is 0.5 m) culls at its extent's
    ulp instead.  Without one, the arithmetic is the JAX session's.

    On a CUDA device the kernel library is built (or loaded) here, so the
    first frame does not wait for nvcc.  Frame i of `step_frames` is
    bit-equal to `step` on the same frustum at the same `a_cap` (one
    kernel, one arithmetic per node and frame).

    While a torch.profiler session runs, each call records the spans
    `select.prep` (the frustum's axes and projections, the pad),
    `select.upload` (four copies to the device), `select.launch` (K5 and
    the sort, as enqueued, and `step_capped`'s cut) and `select.fetch`
    (the copies back, which wait for the device), and the counters
    `select.fetch_bytes` (bytes copied back) and, in `step_capped`,
    `select.visible` (nodes visible before the cap) (utils/progress)."""

    def __init__(self, node_mins, node_edges, num_points,
                 axis_capacity: int = 32, device="cuda", origin=None) -> None:
        self.device = resolve_device(device)
        self.a_cap = int(axis_capacity)
        self.origin = (None if origin is None
                       else np.asarray(origin, dtype=np.float64).reshape(3))
        if self.origin is None:
            mins = np.asarray(node_mins, dtype=np.float32)
        else:
            mins = (np.asarray(node_mins, dtype=np.float64).reshape(-1, 3)
                    - self.origin).astype(np.float32)
        self._mins = torch.as_tensor(mins.reshape(-1, 3), device=self.device)
        self._edges = torch.as_tensor(
            np.asarray(node_edges, dtype=np.float32), device=self.device)
        self._num_points = torch.as_tensor(
            np.asarray(num_points, dtype=np.int32), device=self.device)
        if self.device.type == "cuda":
            from . import _ext

            _ext.lib()

    def _grow(self, a: int) -> int:
        """The width for a frame of `a` axes: a_cap, grown once to 2a
        when a frame needs more (next frames reuse the new width)."""
        if a > self.a_cap:
            self.a_cap = int(a * 2)
        return self.a_cap

    def _pad(self, axes, qmin, qmax):
        return pad_cull_axes(axes, qmin, qmax, self._grow(len(axes)))

    def _put(self, array: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(array, dtype=torch.float32, device=self.device)

    def _upload(self, frustum) -> list:
        """One frame's matrix, axes and projections, on the device."""
        with span("select.prep"):
            axes, qmin, qmax = frustum_axes_and_projections(frustum,
                                                            self.origin)
            ax, qn, qx = self._pad(axes, qmin, qmax)
            mat = local_clip_matrix(frustum.clip_from_query, self.origin)
        with span("select.upload"):
            return [self._put(a) for a in (mat, ax, qn, qx)]

    def step(self, frustum) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One frame -> (priority_order (K,) i32, sizes (K,), visible (K,))."""
        args = self._upload(frustum)
        with span("select.launch"):
            order, sizes, visible = frustum_cull_lod_select(
                *args, self._mins, self._edges, self._num_points)
        with span("select.fetch"):
            out = (order.cpu().numpy(), sizes.cpu().numpy(),
                   visible.cpu().numpy())
        count("select.fetch_bytes", sum(a.nbytes for a in out))
        return out

    def step_capped(self, frustum, cap: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """One frame -> (order (n,) i32, sizes (n,) f32, visible): the
        first n = min(visible, cap) entries of `step`'s order, bit for bit,
        their sizes, and the count of visible nodes."""
        args = self._upload(frustum)
        with span("select.launch"):
            order, sizes, visible = frustum_cull_lod_select(
                *args, self._mins, self._edges, self._num_points)
            head = order[:cap]
            packed = torch.cat([
                head, sizes.index_select(0, head).view(torch.int32),
                visible.sum(dtype=torch.int32).reshape(1)])
        with span("select.fetch"):
            host = packed.cpu().numpy()
        h = len(head)
        seen = int(host[-1])
        n = min(seen, h)
        count("select.fetch_bytes", host.nbytes)
        count("select.visible", seen)
        return host[:n], host[h:h + n].view(np.float32), seen

    def step_frames(self, frustums) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """F frames in ONE launch -> ((F, K) orders, sizes, visible)."""
        frustums = list(frustums)
        if not frustums:
            k = len(self._edges)
            return (
                np.empty((0, k), np.int32),
                np.empty((0, k), np.float32),
                np.empty((0, k), bool),
            )
        with span("select.prep"):
            prep = [frustum_axes_and_projections(f, self.origin)
                    for f in frustums]
            a_cap = self._grow(max(len(p[0]) for p in prep))
            frames = _stack_frames(frustums, prep, a_cap, self.origin)
        with span("select.upload"):
            args = [self._put(a) for a in frames]
        with span("select.launch"):
            order, sizes, visible = frustum_cull_lod_select(
                *args, self._mins, self._edges, self._num_points)
        with span("select.fetch"):
            out = (order.cpu().numpy(), sizes.cpu().numpy(),
                   visible.cpu().numpy())
        count("select.fetch_bytes", sum(a.nbytes for a in out))
        return out
