"""The Octree container: metadata table + vectorized visible-node selection
(copy of point_cloud_viewer_tpu/octree/octree.py:36-554, trimmed to what
the viewers, the web server, the query client and the chip check call).

Where the reference walks a NodeId->NodeMeta hash map with a BinaryHeap
(src/octree/mod.rs:228-283), this container keeps ALL node metadata as flat
arrays (levels, paths, counts, cube minima/edges) so that visible-node
selection is one vectorized pass: SAT-cull every node cube against the
frustum and order survivors by projected screen size.

The host cull runs the port's own native library (native/), and its
coarse-index branch takes `_ranges_to_indices` from the port's builder, so
nothing here reaches jax.  Node point data is decoded through io.node_io.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.attributes import (
    AttributeDataType,
    OCTREE_STANDARD_ATTRIBUTES,
)
from ..core.points_batch import PointsBatch
from ..io.node_io import DataProvider, OnDiskDataProvider, read_node_batch
from ..math.geometry import Aabb, Cube
from ..ops.codec import PositionEncoding
from .node_id import (
    NodeId, bounding_cubes, bounding_cubes2, ids_at, split_upper_words,
    unpack_ids)

_CORNER_UNIT = np.array(
    [[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)], dtype=np.float64
)  # (8, 3)

_COARSE_LEVEL = 5  # <= 8^5 = 32768 ancestor cells in the coarse pass
_HIER_THRESHOLD = 100_000  # node count above which the coarse index builds


@dataclass
class NodeMeta:
    num_points: int
    position_encoding: PositionEncoding
    cube_min: np.ndarray
    edge_length: float


class _LazyNodeIds:
    """Sequence of NodeId built on demand from the packed arrays — at
    ~1M-node scale, materializing a million Python objects up front costs
    seconds; queries only ever touch a visible subset."""

    __slots__ = ("levels", "path_hi", "path_lo")

    def __init__(self, levels, path_hi, path_lo) -> None:
        self.levels = levels
        self.path_hi = path_hi
        self.path_lo = path_lo

    def __len__(self) -> int:
        return len(self.levels)

    def __getitem__(self, i) -> NodeId:
        path = (int(self.path_hi[i]) << 64) | int(self.path_lo[i])
        return NodeId.from_level_index(int(self.levels[i]), path)

    def __iter__(self):
        for i in range(len(self.levels)):
            yield self[i]


def _node_names_json(levels, path_hi, path_lo, order) -> bytes:
    """JSON array bytes of node-id strings ("r" + octal path) for row
    indices `order` — fully vectorized, no per-node Python objects.

    The reference backend serializes ids in Rust (octree_web_viewer/src/
    backend.rs:16-64); at 1B-cloud scale (~71k visible nodes) the Python
    NodeId-object + str() + json.dumps chain costs ~230 ms per request on
    a 1-core host, vs ~2 ms here.  Handles the format's full level range
    (level <= 40: 120-bit paths split across the 56-bit hi word and lo)."""
    order = np.asarray(order, dtype=np.int64)
    if len(order) == 0:
        return b"[]"
    lv = levels[order].astype(np.int64)
    hi = path_hi[order]
    lo = path_lo[order]
    lengths = lv + 4  # quote, 'r', digits, quote, comma
    starts = np.empty(len(order) + 1, dtype=np.int64)
    starts[0] = 0
    np.cumsum(lengths, out=starts[1:])
    buf = np.empty(1 + int(starts[-1]), dtype=np.uint8)
    buf[0] = ord("[")
    p = 1 + starts[:-1]
    buf[p] = ord('"')
    buf[p + 1] = ord("r")
    buf[p + 2 + lv] = ord('"')
    buf[p + 3 + lv] = ord(",")
    buf[-1] = ord("]")  # the trailing comma slot
    # Octal digits, least-significant first: digit k's 3-bit window sits at
    # a CONSTANT shift 3k, so each iteration is one uniform vector op.  The
    # only lo/hi straddle a 3k shift can hit is s=63 (s=62 is not a
    # multiple of 3): bit 63 of lo + bits 0-1 of hi.
    max_lv = int(lv.max())
    for k in range(max_lv):
        s = 3 * k
        if s <= 61:
            d = (lo >> np.uint64(s)) & np.uint64(7)
        elif s == 63:
            d = (lo >> np.uint64(63)) | ((hi & np.uint64(3)) << np.uint64(1))
        else:
            d = (hi >> np.uint64(s - 64)) & np.uint64(7)
        sel = lv > k
        pos = p[sel] + 2 + (lv[sel] - 1 - k)
        buf[pos] = 48 + d[sel].astype(np.uint8)
    return buf.tobytes()


class Octree:
    """An on-disk octree opened for viewing and serving."""

    # Class-level: guards the lazy node-id index build; class-level (not
    # per-instance) so Octree.__new__-constructed synthetic trees have it.
    _index_lock = threading.Lock()

    def __init__(self, data_provider: DataProvider) -> None:
        self.data_provider = data_provider
        # Fast path: the native wire walker parses a current-layout meta.pb
        # directly into arrays (~100x the per-node Python decode at ~1M
        # nodes); anything unusual (legacy versions, s2) falls back.
        parsed = None
        raw = None
        meta_bytes = getattr(data_provider, "meta_bytes", None)
        if meta_bytes is not None:
            raw = meta_bytes()
        if raw is not None:
            from .. import native

            parsed = native.parse_octree_meta(raw)
        if parsed is not None:
            from ..core.constants import CURRENT_VERSION

            if parsed[0] != CURRENT_VERSION:
                # Unknown versions must go through the Python decoder's
                # version policy (migrate or raise), not be accepted just
                # because the wire layout happens to match.
                parsed = None
        if parsed is not None:
            version, bbox, resolution, id_hi, id_lo, num_points, enc = parsed
            self.meta_version = version
            self.resolution = resolution
            self.bounding_box = Aabb(bbox[:3], bbox[3:])
            self.levels, self.path_hi = split_upper_words(id_hi)
            self.path_lo = id_lo
            self.num_points = num_points
            if len(enc) and (enc.min() < 1 or enc.max() > 4):
                raise ValueError("PositionEncoding is invalid")
            from .node_id import MAX_FORMAT_LEVEL

            if len(self.levels) and int(self.levels.max()) > MAX_FORMAT_LEVEL:
                # A level byte > 40 would reach bounding_cubes2 with
                # shifts >= 128 (C-undefined for numpy uint64); the Python
                # decoder path raises for such metas, so must we.
                raise ValueError(
                    f"node level exceeds the format maximum of {MAX_FORMAT_LEVEL}"
                )
            self._encoding_codes = enc
            self.node_ids = _LazyNodeIds(self.levels, self.path_hi, self.path_lo)
            self._index: Optional[Dict[int, int]] = None  # built on demand
        else:
            # Decode the bytes already fetched.
            if raw is not None:
                from ..protos.meta import MetaProto

                meta = MetaProto.decode(raw)
            else:
                meta = data_provider.meta_proto()
            if meta.octree is None:
                raise ValueError("No octree meta found")
            self.meta_version = meta.version
            self.resolution = meta.octree.resolution
            self.bounding_box = Aabb(meta.bounding_box.min, meta.bounding_box.max)
            ids = [NodeId(n.id) for n in meta.octree.nodes]
            self.node_ids = ids
            # Two-word paths: the reader serves the format's FULL level
            # range (level <= 40, 120-bit paths) though the builder caps
            # at 21.
            self.levels, self.path_hi, self.path_lo = unpack_ids(ids)
            self.num_points = np.array(
                [n.num_points for n in meta.octree.nodes], dtype=np.int64
            )
            self._encoding_codes = np.array(
                [int(PositionEncoding.from_proto(n.position_encoding))
                 for n in meta.octree.nodes],
                dtype=np.uint8,
            )
            self._index = {n.value: i for i, n in enumerate(ids)}

        self.root_cube = Cube.bounding(self.bounding_box)
        # Hardcoded octree attribute schema (reference: src/octree/mod.rs:52-72).
        self.attribute_data_types: Dict[str, AttributeDataType] = dict(
            OCTREE_STANDARD_ATTRIBUTES
        )
        self.cube_mins, self.cube_edges = bounding_cubes2(
            self.levels, self.path_hi, self.path_lo, self.root_cube
        )
        # Hierarchical cull index for very large node tables: group nodes
        # under their level-_COARSE_LEVEL ancestor so a frame first culls
        # the (few) ancestor cubes and only then their members — exact, not
        # heuristic: a node's cube is contained in its ancestor's, so a
        # separated ancestor implies every member is separated too (the
        # flat-array analogue of the reference's top-down traversal,
        # src/octree/mod.rs:228-283).
        self._coarse = None
        self._heap = None
        if len(self.levels) >= _HIER_THRESHOLD:
            from .. import native

            # The hierarchical paths only run through the native kernels;
            # building the indexes under numpy fallbacks is wasted open time.
            if native.available():
                self._build_coarse_index()
                self._build_heap_index()

    @classmethod
    def from_directory(cls, directory: str) -> "Octree":
        return cls(OnDiskDataProvider(directory))

    def _build_coarse_index(self) -> None:
        from .node_id import shifted_prefix

        lc = _COARSE_LEVEL
        lv = self.levels.astype(np.int64)
        deep = lv >= lc
        # Level-lc ancestor prefix from the two-word path.
        shift = (3 * (lv - lc)).clip(min=0)
        pref = shifted_prefix(self.path_hi, self.path_lo, shift)

        deep_idx = np.nonzero(deep)[0]
        order = np.argsort(pref[deep_idx], kind="stable")
        member_idx = deep_idx[order].astype(np.int64)
        sorted_pref = pref[deep_idx][order]
        upaths, starts = np.unique(sorted_pref, return_index=True)
        offsets = np.append(starts, len(member_idx)).astype(np.int64)
        coarse_mins, coarse_edges = bounding_cubes(
            np.full(len(upaths), lc, dtype=np.uint8), upaths, self.root_cube
        )
        self._coarse = {
            "mins": coarse_mins,
            "edges": coarse_edges,
            "offsets": offsets,
            "member_idx": member_idx,
            "shallow_idx": np.nonzero(~deep)[0].astype(np.int64),
        }

    def _build_heap_index(self) -> None:
        """Children adjacency for the best-first heap cull: nodes sorted by
        (level, path) so every node's children form one contiguous range in
        the next level's slice.  Requires the meta invariant that every
        node's ancestors are recorded (the builder guarantees it; the
        reference's top-down traversal needs the same,
        src/octree/mod.rs:228-283)."""
        n = len(self.levels)
        lv = self.levels.astype(np.int64)
        order = np.lexsort((self.path_lo, self.path_hi, lv))
        s_lv = lv[order]
        s_hi = self.path_hi[order]
        s_lo = self.path_lo[order]
        max_lv = int(s_lv[-1]) if n else 0
        level_starts = np.searchsorted(s_lv, np.arange(max_lv + 2))
        child_start = np.zeros(n, dtype=np.int32)
        child_end = np.zeros(n, dtype=np.int32)
        for l in range(max_lv):
            a, b = int(level_starts[l]), int(level_starts[l + 1])
            c, d = int(level_starts[l + 1]), int(level_starts[l + 2])
            if a == b or c == d:
                continue
            if 3 * (l + 1) <= 63:
                # Paths fit one u64 word (the common, builder-range case).
                lo_b = s_lo[a:b] << np.uint64(3)
                st = np.searchsorted(s_lo[c:d], lo_b, side="left")
                en = np.searchsorted(s_lo[c:d], lo_b + np.uint64(8), side="left")
            else:
                pk = (s_hi[a:b].astype(object) << 64) | s_lo[a:b].astype(object)
                ck = (s_hi[c:d].astype(object) << 64) | s_lo[c:d].astype(object)
                lo_b = np.array([int(v) << 3 for v in pk], dtype=object)
                hi_b = np.array([(int(v) << 3) + 8 for v in pk], dtype=object)
                st = np.searchsorted(ck, lo_b, side="left")
                en = np.searchsorted(ck, hi_b, side="left")
            child_start[a:b] = (st + c).astype(np.int32)
            child_end[a:b] = (en + c).astype(np.int32)
        root = int(level_starts[0]) if level_starts[1] > level_starts[0] else -1
        # Safety: the traversal reaches a node only through its parent.  If
        # the meta violates the ancestor invariant (each non-root node's
        # parent recorded exactly once), disable the heap path rather than
        # silently dropping subtrees.
        linked = int((child_end.astype(np.int64) - child_start).sum())
        if root < 0 or linked != n - 1:
            self._heap = None
            return
        self._heap = {
            "mins": np.ascontiguousarray(self.cube_mins[order]),
            "edges": np.ascontiguousarray(self.cube_edges[order]),
            "num_points": np.ascontiguousarray(
                self.num_points[order].astype(np.int32)
            ),
            "child_start": child_start,
            "child_end": child_end,
            "root": root,
            "order": order.astype(np.int64),
        }

    def __len__(self) -> int:
        return len(self.node_ids)

    # -- node lookup -------------------------------------------------------

    def node_ids_at(self, rows) -> List[NodeId]:
        """`[self.node_ids[i] for i in rows]`, made in one pass over the id
        columns that both meta decoders fill."""
        return ids_at(self.levels, self.path_hi, self.path_lo, rows)

    def node_meta(self, node_id: NodeId) -> NodeMeta:
        if self._index is None:
            # Locked: viewer loaders all hit the first node_meta at
            # startup; without the lock each would repeat this whole
            # GIL-bound bigint index build.
            with self._index_lock:
                if self._index is None:
                    lv = self.levels.astype(object)
                    hi = self.path_hi.astype(object)
                    lo = self.path_lo.astype(object)
                    values = (lv << 120) | (hi << 64) | lo
                    self._index = {int(v): i for i, v in enumerate(values)}
        i = self._index[node_id.value]
        return NodeMeta(
            num_points=int(self.num_points[i]),
            position_encoding=PositionEncoding(int(self._encoding_codes[i])),
            cube_min=self.cube_mins[i],
            edge_length=float(self.cube_edges[i]),
        )

    def node_corners(self) -> np.ndarray:
        """(K, 8, 3) world-space corners of every node's cube."""
        return (
            self.cube_mins[:, None, :]
            + _CORNER_UNIT[None, :, :] * self.cube_edges[:, None, None]
        )

    # -- traversal -----------------------------------------------------------

    def get_visible_nodes(
        self, projection_matrix: np.ndarray, max_nodes: Optional[int] = None
    ) -> List[NodeId]:
        """Nodes whose cube intersects the frustum of `projection_matrix`
        (4x4, clip_from_query), largest projected screen size first; empty
        nodes are traversed but not returned (reference:
        src/octree/mod.rs:228-283).  max_nodes bounds the result (top-K by
        screen size — the viewer's node budget)."""
        from ..math.geometry import Frustum

        order, _ = self.visible_nodes_with_sizes(
            Frustum.from_matrix4(projection_matrix), max_nodes=max_nodes
        )
        return [self.node_ids[i] for i in order]

    def visible_node_names_json(
        self, projection_matrix: np.ndarray,
        max_nodes: Optional[int] = None,
    ) -> bytes:
        """get_visible_nodes serialized straight to JSON bytes — the web
        backend's /visible_nodes body — without materializing per-node
        Python objects (same order, same names; see _node_names_json)."""
        from ..math.geometry import Frustum

        order, _ = self.visible_nodes_with_sizes(
            Frustum.from_matrix4(projection_matrix), max_nodes=max_nodes
        )
        return _node_names_json(self.levels, self.path_hi, self.path_lo,
                                order)

    def visible_nodes_with_sizes(self, frustum, max_nodes: Optional[int] = None) -> tuple:
        """Returns (indices ordered by size desc, sizes) of visible nodes.

        Native single-pass kernel when available (corners are expanded on
        the fly — no (K, 8, 3) materialization, and with max_nodes a top-K
        partial sort replaces the full ordering — both matter at ~1M-node
        scale); vectorized-numpy fallback below."""
        from .. import native

        cached = frustum.intersector().cached_axes_for_aabb()
        proj = cached.corners @ cached.axes.T  # (8, A)
        qmin, qmax = proj.min(axis=0), proj.max(axis=0)

        if max_nodes is not None and self._heap is not None:
            # Bounded node budget: best-first heap traversal touches only
            # O(max_nodes) nodes regardless of table size or how much of
            # the cloud the camera sees (reference heap semantics,
            # src/octree/mod.rs:228-283).
            hp = self._heap
            out = native.cull_lod_heap(
                frustum.clip_from_query, cached.axes, qmin, qmax,
                hp["mins"], hp["edges"], hp["num_points"],
                hp["child_start"], hp["child_end"], hp["root"], max_nodes,
            )
            if out is not None:
                order_s, sizes = out
                return hp["order"][order_s], sizes

        if self._coarse is not None and native.available():
            # Phase 1: cull the level-_COARSE_LEVEL ancestor cells (exact:
            # members are geometrically contained in their ancestor cube).
            c = self._coarse
            cell_out = native.cull_lod_select(
                frustum.clip_from_query, cached.axes, qmin, qmax,
                c["mins"], c["edges"],
                np.ones(len(c["edges"]), dtype=np.int32), dtype=np.float64,
                max_out=1,  # ordering is irrelevant here
            )
            if cell_out is not None:
                _, _, cell_vis = cell_out
                sel_cells = np.flatnonzero(cell_vis)
                offs = c["offsets"]
                ranges = np.stack(
                    [offs[sel_cells], offs[sel_cells + 1]], axis=1
                )
                from .builder import _ranges_to_indices

                member_pos = _ranges_to_indices(ranges)
                n_subset = len(c["shallow_idx"]) + len(member_pos)
                # When the frustum sees (nearly) everything, the subset
                # gather is pure per-frame overhead on top of the same
                # full cull — fall through to the flat path instead.
                if n_subset <= 0.6 * len(self.levels):
                    subset = np.concatenate(
                        [c["shallow_idx"], c["member_idx"][member_pos]]
                    )
                    # Phase 2: cull + LOD priority over the survivors only.
                    out = native.cull_lod_select(
                        frustum.clip_from_query, cached.axes, qmin, qmax,
                        self.cube_mins[subset], self.cube_edges[subset],
                        self.num_points[subset], dtype=np.float64,
                        max_out=max_nodes or 0,
                    )
                    if out is not None:
                        order_s, sizes_s, visible_s = out
                        count = int(visible_s.sum())
                        if max_nodes is not None:
                            count = min(count, max_nodes)
                        order_s = order_s[:count]
                        return subset[order_s], sizes_s[order_s]

        out = native.cull_lod_select(
            frustum.clip_from_query, cached.axes, qmin, qmax,
            self.cube_mins, self.cube_edges,
            self.num_points, dtype=np.float64,
            max_out=max_nodes or 0,
        )
        if out is not None:
            order, sizes, visible = out
            count = int(visible.sum())
            if max_nodes is not None:
                count = min(count, max_nodes)
            order = order[:count]
            return order, sizes[order]

        from ..math.sat import REL_OUT

        corners = self.node_corners()
        relation = cached.intersect(corners)
        sizes = relative_sizes_on_screen(frustum.clip_from_query, corners)
        visible = (relation != REL_OUT) & (self.num_points > 0)
        idx = np.nonzero(visible)[0]
        order = idx[np.argsort(-sizes[idx], kind="stable")]
        if max_nodes is not None:
            order = order[:max_nodes]
        return order, sizes[order]

    def nodes_in_location(self, location) -> List[NodeId]:
        """All nodes whose AABB intersects the query location (a
        query.location.PointLocation)."""
        return [nid for nid, _ in self.nodes_in_location_ex(location)]

    def nodes_in_location_ex(self, location) -> List:
        """Like nodes_in_location, but each entry is (NodeId, fully_inside):
        fully_inside=True certifies every point of the node passes the
        query's per-point containment test (the node cube bounds all its
        points by construction), so readers may skip per-point filtering.
        Only claimed where bit-exact (location.fully_inside_bounds)."""
        lo = self.cube_mins
        hi = self.cube_mins + self.cube_edges[:, None]
        if hasattr(location, "intersects_bounds"):
            mask = location.intersects_bounds(lo, hi)
        else:
            mask = location.intersects_aabbs(self.node_corners())
        # Nodes fully drained by LOD promotion are recorded in the meta with
        # 0 points but have NO data files (the reference deletes zero-byte
        # files on writer drop, src/read_write/node_writer.rs:78-89) — they
        # must never reach the readers.
        mask &= self.num_points > 0
        idx = np.nonzero(mask)[0]
        fib = getattr(location, "fully_inside_bounds", None)
        fully = fib(lo[idx], hi[idx]) if (fib is not None and len(idx)) else None
        if fully is None:
            fully = np.zeros(len(idx), dtype=bool)
        return [(self.node_ids[i], bool(f)) for i, f in zip(idx, fully)]

    # -- point access --------------------------------------------------------

    def points_in_node(
        self, node_id: NodeId, attributes: Optional[Sequence[str]] = None
    ) -> PointsBatch:
        """Read and decode one node's points (world-space positions)."""
        meta = self.node_meta(node_id)
        if attributes is None:
            attributes = list(self.attribute_data_types)
        dtypes = {}
        for a in attributes:
            if a not in self.attribute_data_types:
                raise KeyError(f"Data type for attribute '{a}' not found.")
            dtypes[a] = self.attribute_data_types[a]
        return read_node_batch(
            self.data_provider,
            str(node_id),
            dtypes,
            meta.position_encoding,
            meta.cube_min,
            meta.edge_length,
        )

    def get_node_data(self, node_id: NodeId):
        """Raw (undecoded) position+color bytes + meta, the web viewer's
        payload (reference: src/octree/mod.rs:285-307)."""
        blobs = self.data_provider.data(str(node_id), ["position", "color"])
        return self.node_meta(node_id), blobs["position"], blobs["color"]


def relative_sizes_on_screen(matrix: np.ndarray, corners: np.ndarray) -> np.ndarray:
    """Vectorized relative_size_on_screen (reference: src/octree/mod.rs:119-139):
    project all 8 cube corners, clamp to the hemicube (|x|,|y| <= 1,
    0 <= z <= 1), take the xy-area of the projected bounding rectangle.

    corners: (K, 8, 3) -> (K,) f64.
    """
    q = corners @ matrix[:3, :3].T + matrix[:3, 3]  # (K, 8, 3)
    w = corners @ matrix[3, :3].T + matrix[3, 3]  # (K, 8)
    p = q / w[..., None]
    x = np.clip(p[..., 0], -1.0, 1.0)
    y = np.clip(p[..., 1], -1.0, 1.0)
    dx = x.max(axis=1) - x.min(axis=1)
    dy = y.max(axis=1) - y.min(axis=1)
    return dx * dy
