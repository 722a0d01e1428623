"""In-core octree build with the tree derivation on a PyTorch device.

Port of point_cloud_viewer_tpu/octree/builder.py (build_octree,
builder.py:105-304).  The device build runs in four steps:

1. the host quantizes and Morton-encodes the points (ops/morton, native);
2. it sends the 63-bit codes up as one int64 tensor;
3. the device derivation (ops/tree_build.build_tree_device_codes_grouped)
   sorts them, gives each point its leaf level, runs the stride-8 LOD
   promotion and returns the grouped exchange;
4. the host groups the nodes, fixpoint-encodes them and writes the
   reference's on-disk format (meta.pb v13 + per-node files).

Two more routes follow the JAX package's `else` branch (builder.py:244-
289): the host build (`use_device=False`: native sort and tree_levels, or
the numpy split discovery and subsampling without the native library), and
deep builds past the 63-bit code budget (total cap > 21), whose fat
level-21 cells are split by re-rooted sub-builds, on the device for cells
of at least _DEEP_DEVICE_MIN_N points when `use_device` is set.

The host helpers are copied below from the JAX package's builder, and the
layers under them (core, io, protos, math, octree.node_id, ops.codec,
native, utils.progress) are the port's own copies of the JAX package's
modules.  Their behaviour is unchanged, so the bytes on disk are the JAX
package's, byte for byte.

The multi-device build (`mesh`, builder.py:310-413) shards the whole
derivation over a mesh of PyTorch devices (parallel/sharded_build.py) and
finishes the shallow top on the host; with a mesh, deep builds place
their fat-cell sub-builds on the mesh's devices in turn.

The out-of-core build (octree/streaming.py) shares these helpers.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import native
from ..core.constants import CURRENT_VERSION, MAX_POINTS_PER_NODE, META_FILENAME
from ..core.points_batch import PointsBatch, as_points_batch
from ..io.node_io import attempt_increasing_rlimit_to_max, write_node_files
from ..math.geometry import Aabb, Cube
from ..ops import morton
from ..ops.codec import encode_positions, position_encoding_for
from ..protos.meta import (
    BoundingBoxProto,
    MetaProto,
    OctreeMetaProto,
    OctreeNodeProto,
)
from ..utils.progress import timed_phase
from .node_id import MAX_FORMAT_LEVEL, NodeId, bounding_cubes


# --- copied from point_cloud_viewer_tpu/octree/builder.py:52-102 ----------


@dataclass
class _LevelNodes:
    """All nodes of one level: sorted paths + concatenated point-index lists
    (indices into the Morton-sorted point order)."""

    paths: np.ndarray  # (K,) uint64, strictly increasing
    offsets: np.ndarray  # (K+1,) int64 into idx
    idx: np.ndarray  # (total,) int64

    @property
    def counts(self) -> np.ndarray:
        return np.diff(self.offsets)


@dataclass
class BuildResult:
    directory: str
    root_cube: Cube
    resolution: float
    bounding_box: Aabb
    nodes: List[Tuple[NodeId, int]]  # (id, num_points) of every recorded node
    depth_cap: int
    # Mesh builds only: points owned by each shard after the all-to-all.
    shard_points: Optional[List[int]] = None

    @property
    def num_points(self) -> int:
        return sum(n for _, n in self.nodes)


def _materialize(
    data: Union[PointsBatch, Iterable[PointsBatch]]
) -> PointsBatch:
    batch = as_points_batch(data)
    if batch is not None:
        return batch
    return PointsBatch.concatenate([as_points_batch(b) for b in data])


def compute_depth_cap(
    edge_length: float, resolution: float, max_level: int = morton.MAX_DEPTH
) -> int:
    """Deepest node level: keep descending while a node at level d-1 may
    still split (its edge > resolution), capped at max_level (default: the
    63-bit u64 code budget; the format itself allows 40 — the reference
    builder splits as deep as the resolution demands, bounded only by the
    120-bit NodeId path, src/octree/node.rs:56-106).  The root always
    splits, so the cap is at least 1."""
    depth = 1
    while depth < max_level and edge_length / (1 << depth) > resolution:
        depth += 1
    return depth


# --- the build (mirrors builder.py:105-304) -------------------------------


def _add(phase_times: Optional[dict], key: str, value: float) -> None:
    if phase_times is not None:
        phase_times[key] = phase_times.get(key, 0.0) + value


def build_octree(
    output_directory: str,
    resolution: float,
    data: Union[PointsBatch, Iterable[PointsBatch]],
    attributes: Optional[Sequence[str]] = None,
    bounding_box: Optional[Aabb] = None,
    progress: bool = False,
    use_device: bool = True,
    mesh=None,
    phase_times: Optional[dict] = None,
    device="cuda",
) -> BuildResult:
    """Build a reference-format octree directory from points.

    `attributes`: which batch attributes to store (default: all present).
    `bounding_box`: the box the root cube bounds (default: the points'
    own); it is the box meta.pb records, and the depth cap and the Morton
    quantisation follow its cube.
    `progress`: print a `build_octree: <phase>: X.XXXs` line on stderr
    after each phase.
    `use_device`: run the tree derivation (sort + leaf assignment + LOD
    promotion) on `device` ("cuda", or "cpu" for the kernels' plain
    PyTorch versions); False is the host build (native tree_levels, or the
    numpy pair without the native library), which ignores `device`.
    `phase_times`: accumulates wall seconds per phase; deep builds add
    `deep_device_subbuilds` (fat cells derived on a device).
    `mesh`: a tuple of devices (parallel/mesh.make_mesh) -- run the whole
    derivation SHARDED over them with an all-to-all Morton-prefix exchange
    (the multi-device build); `use_device` and `device` are then not read,
    as the JAX package ignores `use_device` there.  On-disk output is
    byte-identical to the single-device build.

    Deep builds (the resolution demands levels past 21, e.g. a
    planet-extent cloud at mm resolution): level-21 cells still over
    MAX_POINTS_PER_NODE are split by re-rooted sub-builds up to the
    format's level 40 (_split_fat_leaves).  With `use_device` the top sort
    and each fat cell of at least _DEEP_DEVICE_MIN_N points run on
    `device`; smaller fat cells take native tree_levels, as in the JAX
    package.  With a `mesh` the top sort runs on its first device and the
    large fat cells go to its devices in turn (builder.py:127-137).  On-disk
    output is byte-identical to the JAX package's build."""
    from ..device import resolve_device
    from ..ops.tree_build import fetch_grouped, tree_codes_grouped_on_device

    if mesh is not None:
        dev = mesh[0]
    else:
        dev = resolve_device(device) if use_device else None

    def phase(label):
        return timed_phase(
            phase_times, label,
            echo=f"build_octree: {label}" if progress else None,
        )

    attempt_increasing_rlimit_to_max()
    batch = _materialize(data)
    if attributes is not None:
        missing = [a for a in attributes if a not in batch.attributes]
        if missing:
            raise ValueError(f"requested attributes not in input: {missing}")
        batch = PointsBatch(
            position=batch.position,
            attributes={a: batch.attributes[a] for a in attributes},
        )
    n = len(batch)
    if bounding_box is None:
        bounding_box = Aabb.bounding_points(batch.position)
    root_cube = Cube.bounding(bounding_box)
    os.makedirs(output_directory, exist_ok=True)

    if n == 0:
        meta = _meta_proto(resolution, bounding_box, [])
        with open(os.path.join(output_directory, META_FILENAME), "wb") as f:
            f.write(meta.encode())
        return BuildResult(output_directory, root_cube, resolution, bounding_box, [], 0)

    total_cap = compute_depth_cap(
        root_cube.edge_length, resolution, max_level=MAX_FORMAT_LEVEL
    )
    depth_cap = min(total_cap, morton.MAX_DEPTH)
    # builder.py:175-180: past the 63-bit code budget, level-21 cells still
    # over MAX_POINTS_PER_NODE are split by re-rooted sub-builds.
    deep = total_cap > depth_cap

    if mesh is not None and depth_cap >= 2 and not deep:
        # builder.py:182-188: a tree of at most a root and one level has
        # no work to distribute; it takes the sort route below.
        return _build_octree_mesh(
            output_directory, resolution, batch, bounding_box, root_cube,
            depth_cap, mesh, phase,
        )

    if dev is not None and mesh is None and not deep:
        # --- 1. Morton encode + the device derivation -------------------
        with phase("quantize+morton"):
            codes_unsorted, _ = morton.quantize_and_encode(
                batch.position, root_cube.min, root_cube.edge_length, depth_cap
            )
        with phase("device core"):
            # 8 B/pt up (int64 codes), ~4 B/pt down via the GROUPED exchange
            # (order2 sorted by (final level, code) + per-level counts +
            # 1-point-leaf extras); the classic idx/final/leaf arrays stay on
            # the device as the extras-overflow fallback (builder.py:205-232).
            got = fetch_grouped(tree_codes_grouped_on_device(
                codes_unsorted, depth_cap, depth_cap, device=dev
            ))
        with phase("group levels"):
            if got.overflow:
                order = got.idx
                final_nodes = _group_device_levels(
                    codes_unsorted[order], got.final, got.leaf, depth_cap
                )
            else:
                order = got.order2
                final_nodes, _ = _group_subtree_levels_from_level_order(
                    codes_unsorted, order, got.level_counts, got.extras_idx,
                    got.extras_level, depth_cap, 0, include_root=True,
                )
    else:
        with phase("quantize+morton"):
            codes, _ = morton.quantize_and_encode(
                batch.position, root_cube.min, root_cube.edge_length, depth_cap
            )
        with phase("sort"):
            if dev is not None:
                # Deep builds reach here with use_device set: the top sort
                # runs on the device, and each large fat cell's subtree
                # derivation too, inside _split_fat_leaves.
                from ..ops.tree_build import argsort_codes_on_device

                codes, order = argsort_codes_on_device(codes, dev)
            else:
                codes, order = morton.argsort_codes(codes)

        deep_nodes: List[Tuple[NodeId, int]] = []
        if deep:
            # Split decisions in the top derivation come from the RAW counts
            # (every ancestor of a fat cell splits), so the deep discover
            # pass counts on the raw codes while slicing the reduced ones.
            with phase("deep subtrees"):
                raw_codes = codes
                codes, order, deep_nodes = _split_fat_leaves(
                    output_directory, codes, order, batch, root_cube,
                    resolution, depth_cap, total_cap, device=dev,
                    mesh=mesh, phase_times=phase_times,
                )
            with phase("discover+subsample"):
                final_nodes = _subsample_bottom_up(
                    _discover_levels_deep(
                        codes, raw_codes, depth_cap, root_cube.edge_length,
                        resolution,
                    )
                )
        else:
            # --- 2+3. leaf discovery + bottom-up LOD subsampling ----------
            with phase("discover+subsample"):
                final_nodes = _derive_final_nodes(
                    codes, len(codes), depth_cap, root_cube.edge_length,
                    resolution,
                )

    # --- 4. encode + write -------------------------------------------------
    with phase("encode+write"):
        nodes = _write_levels(
            output_directory, final_nodes, batch, order, root_cube, resolution,
            phase_times=phase_times,
        )
        if deep:
            nodes.extend(deep_nodes)

    meta = _meta_proto(resolution, bounding_box, nodes)
    with open(os.path.join(output_directory, META_FILENAME), "wb") as f:
        f.write(meta.encode())
    return BuildResult(
        output_directory, root_cube, resolution, bounding_box, nodes, total_cap
    )


# --- the multi-device build (copied from point_cloud_viewer_tpu/octree/
# builder.py:310-413) -------------------------------------------------------


def _build_octree_mesh(
    output_directory: str,
    resolution: float,
    batch: PointsBatch,
    bounding_box: Aabb,
    root_cube: Cube,
    depth_cap: int,
    mesh,
    phase,
) -> BuildResult:
    """The multi-device build: the whole derivation (sort, leaf assignment,
    LOD promotion) runs sharded over the mesh; the host never walks all N
    codes through a serial tree pass.

    The decomposition is the out-of-core bucket builder's, so the output
    is byte-identical to the single-device build:
    - shard boundaries are level-B Morton prefixes, balanced by exact cell
      counts, so every shard owns whole level-B subtrees;
    - per shard on its device: all-to-all exchange, sort, leaf assignment
      and LOD promotion stopped at level B (parallel/sharded_build.py);
    - per shard on the host: group levels > B, gather, fixpoint-encode,
      write node files;
    - the shallow top (levels <= B) is finished from the per-shard
      residuals by the streaming builder's top pass (at most ~N/8 points).

    Reference analogue: generation.rs:152-193 parallelizes the whole build
    over a rayon scope; here the mesh is the scope."""
    from ..parallel.sharded_build import sharded_tree_levels
    from .streaming import _finish_top, top_structure

    n_shards = len(mesh)
    # Enough level-B cells to balance the mesh (>= 8 cells a shard), at
    # least the out-of-core default B = 2, capped by the tree depth.
    b_levels = 2
    while 8**b_levels < 8 * n_shards:
        b_levels += 1
    b_levels = min(b_levels, depth_cap - 1)

    with phase("quantize+morton"):
        codes_unsorted, _ = morton.quantize_and_encode(
            batch.position, root_cube.min, root_cube.edge_length, depth_cap
        )
    with phase("sharded sort+derive"):
        shards = sharded_tree_levels(
            codes_unsorted, mesh, depth_cap, b_levels, depth_cap,
            MAX_POINTS_PER_NODE,
        )

    num_buckets = 8**b_levels
    shift = np.uint64(3 * (depth_cap - b_levels))
    cell_counts = np.bincount(
        (codes_unsorted >> shift).astype(np.int64), minlength=num_buckets
    )
    top_leaf_of_bucket, split_b = top_structure(
        cell_counts, b_levels, root_cube, resolution, depth_cap
    )
    split_lut = np.zeros(num_buckets, dtype=bool)
    if split_b:
        split_lut[list(split_b)] = True

    recorded: List[Tuple[NodeId, int]] = []
    top_inputs: List[Tuple[int, PointsBatch]] = []
    with phase("group+encode+write"):
        for order_s, final_s, leaf_s in shards:
            if len(order_s) == 0:
                continue
            codes_s = codes_unsorted[order_s]
            pfx = (codes_s >> shift).astype(np.int64)
            # Cells whose level-B node does not split (under a shallow leaf,
            # or small) go to the top pass whole: the device derived them
            # as if the level-B root split, which does not hold for them.
            in_split = split_lut[pfx]
            final_s = np.where(in_split, final_s, b_levels).astype(np.uint8)
            leaf_s = np.where(in_split, leaf_s, b_levels).astype(np.uint8)
            grouped, residual_idx = _group_subtree_levels(
                codes_s, final_s, leaf_s, depth_cap, b_levels
            )
            recorded.extend(
                _write_levels(
                    output_directory, grouped, batch, order_s, root_cube,
                    resolution,
                )
            )
            r_leaf = top_leaf_of_bucket[pfx[residual_idx]]
            r_lvl = np.where(r_leaf >= 0, r_leaf, b_levels)
            for lvl in np.unique(r_lvl):
                sel = residual_idx[r_lvl == lvl]
                top_inputs.append((int(lvl), batch.take(order_s[sel])))
    with phase("top"):
        recorded.extend(
            _finish_top(
                output_directory, top_inputs, root_cube, resolution, depth_cap
            )
        )

    meta = _meta_proto(resolution, bounding_box, recorded)
    with open(os.path.join(output_directory, META_FILENAME), "wb") as f:
        f.write(meta.encode())
    return BuildResult(
        output_directory, root_cube, resolution, bounding_box, recorded,
        depth_cap, shard_points=[len(s[0]) for s in shards],
    )


# --- deep builds (copied from point_cloud_viewer_tpu/octree/builder.py:417-
# 692) ------------------------------------------------------------------------


# Device deep sub-builds only for cells at least this large (builder.py:
# 417-420; the JAX package bounds its XLA compiles with it).  Smaller fat
# cells take native tree_levels, as in the JAX package.
_DEEP_DEVICE_MIN_N = 1_000_000


def _split_fat_leaves(
    directory: str,
    codes: np.ndarray,
    order: np.ndarray,
    batch: PointsBatch,
    root_cube: Cube,
    resolution: float,
    depth_cap: int,
    total_cap: int,
    device=None,
    mesh=None,
    phase_times: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray, List[Tuple[NodeId, int]]]:
    """Deep-tree recursion: level-`depth_cap` cells holding more than
    MAX_POINTS_PER_NODE points are split past the u64 code budget by
    re-rooted sub-builds (fresh 63-bit code space inside the cell's cube —
    the same per-node re-rooting the reference's recursive splitter does,
    src/octree/generation.rs:152-193), down to `total_cap` <= 40.

    Writes all nodes DEEPER than depth_cap and returns reduced
    (codes, order) where each fat run is replaced by its sub-build residual
    (always <= MAX_POINTS_PER_NODE points), so the standard top derivation
    sees the cell as an ordinary leaf.

    The fat cells of at least _DEEP_DEVICE_MIN_N points are derived on
    `mesh`'s devices round-robin, or on `device` alone without a mesh (None
    for both: the host build).  They are dispatched ahead through a sliding
    window of at most one in-flight sub-build a device (builder.py:458-
    497), so on a mesh they overlap each other and the host's per-cell
    group/encode/write loop while the host buffers stay bounded; on one
    device the window dispatches cell i+1 only after cell i is fetched.
    Each sub-build is self-contained, so only its placement changes and the
    bytes do not."""
    uniq, counts = _sorted_unique_counts(codes)
    fat = counts > MAX_POINTS_PER_NODE
    if not fat.any():
        return codes, order, []
    run_offsets = np.concatenate([[0], np.cumsum(counts)])
    fat_idx = np.flatnonzero(fat)
    devs = (list(mesh) if mesh is not None
            else [device] if device is not None else [])
    eligible = [
        int(i) for i in fat_idx
        if int(run_offsets[i + 1]) - int(run_offsets[i]) >= _DEEP_DEVICE_MIN_N
    ] if devs else []
    pending = {}
    next_slot = 0

    def refill():
        nonlocal next_slot
        while next_slot < len(eligible) and len(pending) < len(devs):
            i = eligible[next_slot]
            s, e = int(run_offsets[i]), int(run_offsets[i + 1])
            pending[i] = _dispatch_deep_device(
                batch, order[s:e], int(uniq[i]), root_cube, depth_cap,
                total_cap, device=devs[next_slot % len(devs)],
            )
            next_slot += 1

    refill()
    recorded: List[Tuple[NodeId, int]] = []
    keep_codes: List[np.ndarray] = []
    keep_order: List[np.ndarray] = []
    prev_end = 0
    for i in fat_idx:
        s, e = int(run_offsets[i]), int(run_offsets[i + 1])
        keep_codes.append(codes[prev_end:s])
        keep_order.append(order[prev_end:s])
        residual_order, nodes = _build_deep_subtree(
            directory, batch, order[s:e], int(uniq[i]), root_cube,
            resolution, depth_cap, total_cap, phase_times=phase_times,
            precomputed=pending.pop(int(i), None),
        )
        refill()
        recorded.extend(nodes)
        keep_codes.append(np.full(len(residual_order), uniq[i], dtype=np.uint64))
        keep_order.append(residual_order)
        prev_end = e
    keep_codes.append(codes[prev_end:])
    keep_order.append(order[prev_end:])
    return np.concatenate(keep_codes), np.concatenate(keep_order), recorded


def _dispatch_deep_device(
    batch: PointsBatch,
    run_order: np.ndarray,
    cell_path: int,
    root_cube: Cube,
    depth_cap: int,
    total_cap: int,
    device,
):
    """Encode one fat cell's points in its re-rooted 63-bit code space and
    launch its grouped subtree derivation on `device`'s current stream;
    returns at once (sub_codes, the device GroupedExchange)."""
    from ..ops.tree_build import tree_codes_grouped_on_device

    cube = NodeId.from_level_index(depth_cap, cell_path).find_bounding_cube(
        root_cube
    )
    d2 = total_cap - depth_cap
    sub_codes, _ = morton.quantize_and_encode(
        batch.position[run_order], cube.min, cube.edge_length, d2
    )
    return sub_codes, tree_codes_grouped_on_device(
        sub_codes, d2, d2, device=device
    )


def _build_deep_subtree(
    directory: str,
    batch: PointsBatch,
    run_order: np.ndarray,
    cell_path: int,
    root_cube: Cube,
    resolution: float,
    depth_cap: int,
    total_cap: int,
    phase_times: Optional[dict] = None,
    precomputed=None,
) -> Tuple[np.ndarray, List[Tuple[NodeId, int]]]:
    """Build the subtree under one fat level-`depth_cap` cell: a standard
    sort-based build re-rooted at the cell's cube (sub-depth
    total_cap - depth_cap <= 19, so one recursion level reaches the
    format's level-40 capacity).  `run_order` indexes the original batch in
    globally-sorted order (all points share the cell's code, so ties keep
    original order).  Returns (residual order — the cell's post-subtree
    content — and the recorded deep nodes).

    `precomputed` is the derivation _dispatch_deep_device launched on a
    device (the grouped exchange, or the classic arrays on extras
    overflow); without it the cell is derived by native tree_levels, or the
    numpy pair without the native library.  All routes write the same
    bytes."""
    from ..ops.tree_build import fetch_grouped

    node_id = NodeId.from_level_index(depth_cap, cell_path)
    cube = node_id.find_bounding_cube(root_cube)
    d2 = total_cap - depth_cap
    if not 1 <= d2 <= morton.MAX_DEPTH:
        raise ValueError(f"sub-build depth {d2} outside [1, {morton.MAX_DEPTH}]")

    if precomputed is not None:
        sub_codes, out = precomputed
        got = fetch_grouped(out)
        _add(phase_times, "deep_device_subbuilds", 1)
        if got.overflow:
            o = got.idx
            final_nodes, residual_idx = _group_subtree_levels(
                sub_codes[o], got.final, got.leaf, d2, 0,
            )
        else:
            o = got.order2
            final_nodes, residual_idx = _group_subtree_levels_from_level_order(
                sub_codes, o, got.level_counts, got.extras_idx,
                got.extras_level, d2, 0,
            )
        sub_order = run_order[o]
    else:
        sub_codes, _ = morton.quantize_and_encode(
            batch.position[run_order], cube.min, cube.edge_length, d2
        )
        sub_codes, sub_sort = morton.argsort_codes(sub_codes)
        sub_order = run_order[sub_sort]
        out = native.tree_levels(sub_codes, d2, d2, MAX_POINTS_PER_NODE)
        if out is not None:
            leaf_lv, final_lv = out
            final_nodes, residual_idx = _group_subtree_levels(
                sub_codes, final_lv, leaf_lv, d2, 0
            )
        else:
            levels = _discover_levels(
                sub_codes, len(sub_codes), d2, cube.edge_length, resolution
            )
            final_nodes = _subsample_bottom_up(levels)
            residual_idx = (
                final_nodes.pop(0).idx if 0 in final_nodes
                else np.empty(0, dtype=np.int64)
            )
    nodes = _write_levels(
        directory, final_nodes, batch, sub_order, cube, resolution,
        prefix=node_id,
    )
    return sub_order[residual_idx], nodes


def _discover_levels_deep(
    codes: np.ndarray,
    raw_codes: np.ndarray,
    depth_cap: int,
    root_edge: float,
    resolution: float,
) -> Dict[int, _LevelNodes]:
    """_discover_levels for the deep-tree top pass: point lists come from
    the REDUCED codes (fat runs replaced by their sub-build residuals) but
    split decisions come from the RAW counts — an ancestor of a fat cell
    must split even when its residual content is small, exactly as a flat
    120-bit derivation would decide."""
    leaf_acc: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    split_paths = np.zeros(1, dtype=np.uint64)
    split_ends = np.full(1, len(codes), dtype=np.int64)

    for level in range(1, depth_cap + 1):
        k = len(split_paths)
        shift = np.uint64(3 * (depth_cap - level))
        child_paths = (split_paths[:, None] << np.uint64(3)) | np.arange(8, dtype=np.uint64)
        bounds = child_paths << shift
        upper = bounds + (np.uint64(1) << shift)
        starts = np.searchsorted(codes, bounds.ravel(), side="left").astype(np.int64)
        ends = np.concatenate(
            [starts.reshape(k, 8)[:, 1:], split_ends[:, None]], axis=1
        ).ravel()
        raw_counts = (
            np.searchsorted(raw_codes, upper.ravel(), side="left")
            - np.searchsorted(raw_codes, bounds.ravel(), side="left")
        )
        nonempty = raw_counts > 0

        edge = root_edge / (1 << level)
        can_split = level < depth_cap and edge > resolution
        if can_split:
            is_leaf = nonempty & (raw_counts <= MAX_POINTS_PER_NODE)
        else:
            is_leaf = nonempty

        if is_leaf.any():
            leaf_acc[level] = (
                child_paths.ravel()[is_leaf],
                np.stack([starts[is_leaf], ends[is_leaf]], axis=1),
            )

        splitting = nonempty & ~is_leaf
        split_paths = child_paths.ravel()[splitting]
        split_ends = ends[splitting]
        if len(split_paths) == 0:
            break

    out: Dict[int, _LevelNodes] = {}
    for level, (paths, ranges) in leaf_acc.items():
        counts = ranges[:, 1] - ranges[:, 0]
        offsets = np.concatenate([[0], np.cumsum(counts)])
        out[level] = _LevelNodes(
            paths=paths, offsets=offsets, idx=_ranges_to_indices(ranges)
        )
    return out


# --- the host derivation (copied from point_cloud_viewer_tpu/octree/
# builder.py:695-773) ----------------------------------------------------------


def _derive_final_nodes(
    codes: np.ndarray,
    n: int,
    depth_cap: int,
    root_edge: float,
    resolution: float,
) -> Dict[int, _LevelNodes]:
    """Sorted codes -> final per-level node lists (leaf assignment + LOD
    promotion).  Large inputs use the native per-point kernel (the host
    mirror of the device derivation — same rules, same output); fallback
    is the vectorized-numpy top-down/bottom-up pair."""
    if n >= 100_000:
        out = native.tree_levels(codes, depth_cap, depth_cap, MAX_POINTS_PER_NODE)
        if out is not None:
            leaf, final = out
            return _group_device_levels(codes, final, leaf, depth_cap)
    levels = _discover_levels(codes, n, depth_cap, root_edge, resolution)
    return _subsample_bottom_up(levels)


def _discover_levels(
    codes: np.ndarray,
    n: int,
    depth_cap: int,
    root_edge: float,
    resolution: float,
) -> Dict[int, _LevelNodes]:
    """Walk levels top-down over the sorted codes; returns, per level, the
    leaf nodes created there (interior nodes enter later via subsampling).
    The root (level 0) is always split."""
    split_paths = np.zeros(1, dtype=np.uint64)
    split_ends = np.full(1, n, dtype=np.int64)
    leaf_acc: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    for level in range(1, depth_cap + 1):
        k = len(split_paths)
        shift = np.uint64(3 * (depth_cap - level))
        child_paths = (split_paths[:, None] << np.uint64(3)) | np.arange(8, dtype=np.uint64)
        bounds = child_paths << shift  # first code of each child cell
        starts = np.searchsorted(codes, bounds.ravel(), side="left").astype(np.int64)
        ends = np.concatenate(
            [starts.reshape(k, 8)[:, 1:], split_ends[:, None]], axis=1
        ).ravel()
        counts = ends - starts
        nonempty = counts > 0

        edge = root_edge / (1 << level)
        can_split = level < depth_cap and edge > resolution
        if can_split:
            is_leaf = nonempty & (counts <= MAX_POINTS_PER_NODE)
        else:
            is_leaf = nonempty

        if is_leaf.any():
            leaf_acc[level] = (
                child_paths.ravel()[is_leaf],
                np.stack([starts[is_leaf], ends[is_leaf]], axis=1),
            )

        splitting = nonempty & ~is_leaf
        split_paths = child_paths.ravel()[splitting]
        split_ends = ends[splitting]
        if len(split_paths) == 0:
            break

    out: Dict[int, _LevelNodes] = {}
    for level, (paths, ranges) in leaf_acc.items():
        counts = ranges[:, 1] - ranges[:, 0]
        offsets = np.concatenate([[0], np.cumsum(counts)])
        out[level] = _LevelNodes(
            paths=paths, offsets=offsets, idx=_ranges_to_indices(ranges)
        )
    return out


# --- copied from point_cloud_viewer_tpu/octree/builder.py:776-862 ---------


def _ranges_to_indices(ranges: np.ndarray) -> np.ndarray:
    """[(start, end)] -> concatenated arange(start, end) per row."""
    counts = ranges[:, 1] - ranges[:, 0]
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    # start of each output segment
    seg_offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out = np.repeat(ranges[:, 0] - seg_offsets, counts)
    return out + np.arange(total, dtype=np.int64)


def _merge_levels(a: _LevelNodes, b: _LevelNodes) -> _LevelNodes:
    """Merge two disjoint node sets of the same level, keeping paths sorted."""
    paths = np.concatenate([a.paths, b.paths])
    order = np.argsort(paths, kind="stable")
    counts = np.concatenate([a.counts, b.counts])[order]
    all_segments = [a.idx[a.offsets[i] : a.offsets[i + 1]] for i in range(len(a.paths))]
    all_segments += [b.idx[b.offsets[i] : b.offsets[i + 1]] for i in range(len(b.paths))]
    segments = [all_segments[i] for i in order]
    idx = np.concatenate(segments) if segments else np.empty(0, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return _LevelNodes(paths=paths[order], offsets=offsets, idx=idx)


def _subsample_bottom_up(
    levels: Dict[int, _LevelNodes], stop_level: int = 0
) -> Dict[int, _LevelNodes]:
    """Promote every 8th point of each node to its parent, deepest level
    first; returns the FINAL point lists per level (what gets written).

    With stop_level > 0, promotion stops there: levels > stop_level are
    final and the accumulated (pre-promotion) lists AT stop_level are
    returned under that key — the out-of-core builder's bucket residual."""
    if not levels:
        return {}
    final: Dict[int, _LevelNodes] = {}
    deepest = max(levels)
    current: Optional[_LevelNodes] = None  # all nodes at `level`
    for level in range(deepest, stop_level, -1):
        node_set = levels.get(level)
        if current is not None and node_set is not None:
            node_set = _merge_levels(current, node_set)
        elif current is not None:
            node_set = current
        if node_set is None:
            current = None
            continue

        counts = node_set.counts
        pos_in_node = np.arange(len(node_set.idx), dtype=np.int64) - np.repeat(
            node_set.offsets[:-1], counts
        )
        promote = pos_in_node % 8 == 0

        # Final content of this level's nodes.
        keep_counts = counts - _segment_sum_bool(promote, node_set.offsets)
        final[level] = _LevelNodes(
            paths=node_set.paths,
            offsets=np.concatenate([[0], np.cumsum(keep_counts)]),
            idx=node_set.idx[~promote],
        )

        # Parent nodes: group promoted points by parent path (children are
        # sorted, so each parent's children are consecutive).
        parent_of_node = node_set.paths >> np.uint64(3)
        parent_paths, parent_starts = np.unique(parent_of_node, return_index=True)
        promoted_counts = counts - keep_counts
        parent_counts = np.add.reduceat(promoted_counts, parent_starts)
        current = _LevelNodes(
            paths=parent_paths,
            offsets=np.concatenate([[0], np.cumsum(parent_counts)]),
            idx=node_set.idx[promote],
        )
    if current is not None:
        # stop_level == 0: the root keeps everything it received; otherwise
        # the stop level's pre-promotion lists are handed back to the caller.
        final[stop_level] = (
            _merge_levels(current, levels[stop_level])
            if stop_level in levels
            else current
        )
    elif stop_level in levels:
        final[stop_level] = levels[stop_level]
    return final


# --- copied from point_cloud_viewer_tpu/octree/builder.py:1098-1100 --------


def _segment_sum_bool(mask: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    cs = np.concatenate([[0], np.cumsum(mask)])
    return cs[offsets[1:]] - cs[offsets[:-1]]


# --- copied from point_cloud_viewer_tpu/octree/builder.py:863-955 ---------


def _sorted_unique_counts(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """unique + counts of an ALREADY SORTED array, without re-sorting."""
    if len(a) == 0:
        return a, np.zeros(0, dtype=np.int64)
    starts_mask = np.empty(len(a), dtype=bool)
    starts_mask[0] = True
    np.not_equal(a[1:], a[:-1], out=starts_mask[1:])
    starts = np.flatnonzero(starts_mask)
    counts = np.diff(np.append(starts, len(a)))
    return a[starts], counts


def _group_device_levels(
    codes: np.ndarray,
    final_levels: np.ndarray,
    leaf_levels: np.ndarray,
    depth_cap: int,
) -> Dict[int, _LevelNodes]:
    """Group per-point (final_level, leaf_level) output — from the device
    core or the native host kernel — into the per-level node lists the
    writer consumes.  The node SET is every leaf node plus all ancestors
    (nodes drained empty by promotion are still recorded with 0 points,
    matching the host path and the reference's finished_nodes)."""
    groups = _level_groups(codes, final_levels, leaf_levels, depth_cap)
    order_final, final_starts, occupied_by_level, leaf_paths_by_level = groups

    # All nodes that exist: leaves + every ancestor.
    node_paths: Dict[int, np.ndarray] = {}
    carry = np.empty(0, dtype=np.uint64)
    for level in range(depth_cap, 0, -1):
        node_paths[level] = np.union1d(carry, leaf_paths_by_level[level])
        carry = np.unique(node_paths[level] >> np.uint64(3))
    node_paths[0] = np.zeros(1, dtype=np.uint64)

    out: Dict[int, _LevelNodes] = {}
    for level, paths in node_paths.items():
        if len(paths) == 0:
            continue
        sel = order_final[final_starts[level] : final_starts[level + 1]]
        # Count of points per node (0 for drained nodes).
        counts = np.zeros(len(paths), dtype=np.int64)
        occupied, occ_counts = occupied_by_level[level]
        pos = np.searchsorted(paths, occupied)
        counts[pos] = occ_counts
        offsets = np.concatenate([[0], np.cumsum(counts)])
        out[level] = _LevelNodes(
            paths=paths.astype(np.uint64), offsets=offsets, idx=sel
        )
    return out


def _level_groups(codes, final_levels, leaf_levels, depth_cap):
    """Shared grouping primitive: splits points by level (stable — code
    order preserved) and produces per-level occupied node paths+counts and
    distinct leaf prefixes.  Native single-pass kernel when available; the
    numpy fallback gathers codes per level."""
    num_levels = depth_cap + 1
    full = native.group_levels_full(
        codes, final_levels, leaf_levels, depth_cap, num_levels
    )
    if full is not None:
        (idx_by_level, level_starts, node_paths_flat, node_counts_flat,
         node_offsets, leaf_paths_flat, leaf_offsets) = full
        occupied = {
            l: (node_paths_flat[node_offsets[l] : node_offsets[l + 1]],
                node_counts_flat[node_offsets[l] : node_offsets[l + 1]])
            for l in range(num_levels)
        }
        leaf_paths = {
            l: leaf_paths_flat[leaf_offsets[l] : leaf_offsets[l + 1]]
            for l in range(num_levels)
        }
        return idx_by_level, level_starts, occupied, leaf_paths

    def _split_by_level(levels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        order = np.argsort(levels, kind="stable").astype(np.int64)
        return order, np.searchsorted(levels[order], np.arange(num_levels + 1))

    order_final, final_starts = _split_by_level(final_levels)
    order_leaf, leaf_starts = _split_by_level(leaf_levels)
    occupied = {}
    leaf_paths = {}
    for level in range(num_levels):
        shift = np.uint64(3 * (depth_cap - level))
        sel = order_final[final_starts[level] : final_starts[level + 1]]
        # stable split keeps original (code) order within a level, so
        # per-level prefixes are already sorted.
        occupied[level] = _sorted_unique_counts(codes[sel] >> shift)
        lsel = order_leaf[leaf_starts[level] : leaf_starts[level + 1]]
        leaf_paths[level], _ = _sorted_unique_counts(codes[lsel] >> shift)
    return order_final, final_starts, occupied, leaf_paths


# --- copied from point_cloud_viewer_tpu/octree/builder.py:958-993 ---------


def _group_subtree_levels(
    codes: np.ndarray,
    final_levels: np.ndarray,
    leaf_levels: np.ndarray,
    depth_cap: int,
    root_level: int,
) -> Tuple[Dict[int, _LevelNodes], np.ndarray]:
    """Subtree variant of _group_device_levels for the out-of-core bucket
    path: nodes are grouped for levels root_level+1..depth_cap, and the
    points resting AT root_level (the bucket residual that the caller's top
    pass continues from) are returned as a separate index array."""
    groups = _level_groups(codes, final_levels, leaf_levels, depth_cap)
    order_final, final_starts, occupied_by_level, leaf_paths_by_level = groups

    node_paths: Dict[int, np.ndarray] = {}
    carry = np.empty(0, dtype=np.uint64)
    for level in range(depth_cap, root_level, -1):
        node_paths[level] = np.union1d(carry, leaf_paths_by_level[level])
        carry = np.unique(node_paths[level] >> np.uint64(3))

    grouped: Dict[int, _LevelNodes] = {}
    for level, paths in node_paths.items():
        if len(paths) == 0:
            continue
        sel = order_final[final_starts[level] : final_starts[level + 1]]
        counts = np.zeros(len(paths), dtype=np.int64)
        occupied, occ_counts = occupied_by_level[level]
        pos = np.searchsorted(paths, occupied)
        counts[pos] = occ_counts
        offsets = np.concatenate([[0], np.cumsum(counts)])
        grouped[level] = _LevelNodes(paths=paths.astype(np.uint64),
                                     offsets=offsets, idx=sel)
    residual_idx = order_final[
        final_starts[root_level] : final_starts[root_level + 1]
    ]
    return grouped, residual_idx


# --- copied from point_cloud_viewer_tpu/octree/builder.py:996-1095 --------


def _group_subtree_levels_from_level_order(
    codes_unsorted: np.ndarray,
    order2: np.ndarray,
    level_counts: np.ndarray,
    extras_idx: np.ndarray,
    extras_level: np.ndarray,
    depth_cap: int,
    root_level: int,
    include_root: bool = False,
) -> Tuple[Dict[int, _LevelNodes], np.ndarray]:
    """_group_subtree_levels twin consuming the GROUPED device exchange
    (ops.tree_build.build_tree_device_codes_grouped): `order2` is sorted by
    (final level, code) with values = original indices, `level_counts` are
    the per-level run lengths, and `extras_*` are the 1-point leaves whose
    sole point was promoted away (the empty nodes the reference's
    subsample also leaves behind, generation.rs:195-253).

    Per level, a node's points are one contiguous order2 run, so the
    occupied paths+counts come from prefix run boundaries of
    codes[order2[slice]] — no per-point final/leaf arrays cross the
    host<->device link.  Returned idx arrays index INTO order2 (callers
    pass order2 as the write `order`).  Byte-identical to the classic
    path: tests/test_streaming_build.py pins both routes to one output.

    include_root=True is the IN-CORE (whole tree) variant: the root node
    itself is emitted as a written level (path 0 at root_level, matching
    _group_device_levels) and the residual is empty."""
    num_levels = depth_cap + 1
    starts = np.zeros(num_levels + 1, dtype=np.int64)
    np.cumsum(level_counts[:num_levels], out=starts[1:])

    # Levels strictly below root_level never produce nodes here: the
    # root_level slice is the residual (or the include_root node), whose
    # paths/counts come from starts[] alone — skip its O(residual) gather.
    occupied: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    empty_u64 = np.empty(0, dtype=np.uint64)
    for level in range(root_level + 1, num_levels):
        s0, s1 = int(starts[level]), int(starts[level + 1])
        if s1 <= s0:
            occupied[level] = (empty_u64, np.empty(0, dtype=np.int64))
            continue
        pref = codes_unsorted[order2[s0:s1]] >> np.uint64(
            3 * (depth_cap - level)
        )
        mask = np.empty(len(pref), dtype=bool)
        mask[0] = True
        np.not_equal(pref[1:], pref[:-1], out=mask[1:])
        bounds = np.flatnonzero(mask)
        counts = np.diff(np.append(bounds, len(pref)))
        occupied[level] = (pref[bounds], counts)

    extras_paths: Dict[int, np.ndarray] = {}
    if len(extras_idx):
        ecodes = codes_unsorted[extras_idx]
        for level in np.unique(extras_level):
            lv = int(level)
            if lv <= root_level or lv > depth_cap:
                continue
            extras_paths[lv] = (
                ecodes[extras_level == level]
                >> np.uint64(3 * (depth_cap - lv))
            )

    node_paths: Dict[int, np.ndarray] = {}
    carry = empty_u64
    for level in range(depth_cap, root_level, -1):
        paths = np.union1d(carry, occupied[level][0])
        if level in extras_paths:
            paths = np.union1d(paths, extras_paths[level])
        node_paths[level] = paths
        carry = np.unique(paths >> np.uint64(3))

    grouped: Dict[int, _LevelNodes] = {}
    for level, paths in node_paths.items():
        if len(paths) == 0:
            continue
        counts = np.zeros(len(paths), dtype=np.int64)
        occ_paths, occ_counts = occupied[level]
        pos = np.searchsorted(paths, occ_paths)
        counts[pos] = occ_counts
        offsets = np.concatenate([[0], np.cumsum(counts)])
        grouped[level] = _LevelNodes(
            paths=paths.astype(np.uint64),
            offsets=offsets,
            idx=np.arange(starts[level], starts[level + 1], dtype=np.int64),
        )
    if include_root:
        n_root = int(starts[root_level + 1] - starts[root_level])
        grouped[root_level] = _LevelNodes(
            paths=np.zeros(1, dtype=np.uint64),
            offsets=np.array([0, n_root], dtype=np.int64),
            idx=np.arange(
                starts[root_level], starts[root_level + 1], dtype=np.int64
            ),
        )
        return grouped, np.empty(0, dtype=np.int64)
    residual_idx = np.arange(
        starts[root_level], starts[root_level + 1], dtype=np.int64
    )
    return grouped, residual_idx


# --- copied from point_cloud_viewer_tpu/octree/builder.py:1103-1267 -------


_ENCODE_CHUNK_POINTS = 8_000_000  # bounds encode scratch to ~300 MB


def _write_levels(
    directory: str,
    final_nodes: Dict[int, _LevelNodes],
    batch: PointsBatch,
    order: np.ndarray,
    root_cube: Cube,
    resolution: float,
    prefix: Optional[NodeId] = None,
    phase_times: Optional[dict] = None,
) -> List[Tuple[NodeId, int]]:
    """Encode per level (one encoding per level) and write node files.

    `batch` is in ORIGINAL order; `order` maps sorted -> original index
    (node idx lists index the sorted order).  Point gather + fixpoint
    encode run fused in one native pass per chunk (no materialized
    per-point min/edge arrays); encoding is chunked over groups of whole
    nodes so peak scratch memory stays bounded regardless of cloud size.

    With `prefix`, levels/paths are RELATIVE to that node: `root_cube` must
    be the prefix node's own cube, and written ids become global
    (prefix.level + level) — the deep-subtree writer for trees past the
    u64 code budget (cube subdivision and per-level encodings stay exact:
    both are powers-of-two divisions of the same f64 root edge).

    `phase_times` gets the main thread's gather and encode
    ("encode+write/encode"), its waits on the pool's writes
    ("encode+write/wait"), and the pool's node-file writes summed over its
    threads ("encode+write/write")."""
    # Node-file write parallelism (IO-bound): PCV_WRITE_THREADS overrides —
    # the analogue of the reference CLI's --num_threads rayon pool size
    # ("set as high as possible for SSDs", src/bin/build_octree.rs:36-38).
    try:
        workers = int(os.environ.get("PCV_WRITE_THREADS", "0") or 0)
    except ValueError:
        workers = 0  # a typo'd env var must not kill the build mid-way
    if workers <= 0:
        workers = min(32, max(4, os.cpu_count() or 4))
    pool = ThreadPoolExecutor(max_workers=workers)
    try:
        return _write_levels_pooled(
            pool, directory, batch, order, final_nodes, root_cube,
            resolution, prefix, phase_times,
        )
    finally:
        # An encode/IO error (e.g. ENOSPC from f.result()) must not leak
        # the pool's worker threads or keep queued writes running.
        pool.shutdown(wait=True, cancel_futures=True)


def _write_node_timed(phase_times, *args) -> None:
    with timed_phase(phase_times, "encode+write/write"):
        write_node_files(*args)


def _write_levels_pooled(
    pool, directory, batch, order, final_nodes, root_cube, resolution, prefix,
    phase_times,
):
    recorded: List[Tuple[NodeId, int]] = []
    order = np.asarray(order, dtype=np.int64)
    pending_futures: list = []
    for level in sorted(final_nodes):
        nodes = final_nodes[level]
        k = len(nodes.paths)
        levels_arr = np.full(k, level, dtype=np.uint8)
        mins, edges = bounding_cubes(levels_arr, nodes.paths, root_cube)
        edge = root_cube.edge_length / (1 << level)
        encoding = position_encoding_for(edge, resolution)
        counts = nodes.counts

        # Chunk over whole nodes.
        node_start = 0
        while node_start < k:
            node_end = node_start
            span = 0
            while node_end < k and (
                span == 0 or span + counts[node_end] <= _ENCODE_CHUNK_POINTS
            ):
                span += int(counts[node_end])
                node_end += 1
            lo = int(nodes.offsets[node_start])
            hi = int(nodes.offsets[node_end])
            global_idx = order[nodes.idx[lo:hi]]
            chunk_counts = counts[node_start:node_end]
            with timed_phase(phase_times, "encode+write/encode"):
                encoded = native.gather_encode(
                    batch.position, global_idx,
                    mins[node_start:node_end], edges[node_start:node_end],
                    nodes.offsets[node_start : node_end + 1] - lo,
                    encoding.numpy_dtype.base,
                )
                if encoded is None:  # no native library: numpy fallback
                    pt_min = np.repeat(mins[node_start:node_end], chunk_counts,
                                       axis=0)
                    pt_edge = np.repeat(edges[node_start:node_end], chunk_counts)
                    encoded = encode_positions(
                        batch.position[global_idx], pt_min, pt_edge, encoding
                    )
                    del pt_min, pt_edge
                attrs = {}
                for name, arr in batch.attributes.items():
                    taken = native.take_rows(arr, global_idx)
                    attrs[name] = arr[global_idx] if taken is None else taken
            chunk_futures = []
            for i in range(node_start, node_end):
                if prefix is not None:
                    node_id = NodeId.from_level_index(
                        prefix.level + level,
                        (prefix.index << (3 * level)) | int(nodes.paths[i]),
                    )
                else:
                    node_id = NodeId.from_level_index(level, int(nodes.paths[i]))
                a, b = int(nodes.offsets[i]) - lo, int(nodes.offsets[i + 1]) - lo
                recorded.append((node_id, b - a))
                chunk_futures.append(
                    pool.submit(
                        _write_node_timed, phase_times,
                        os.path.join(directory, str(node_id)),
                        encoded[a:b],
                        {name: arr[a:b] for name, arr in attrs.items()},
                    )
                )
            # Double-buffer: wait on the PREVIOUS chunk's writes before
            # encoding the one after next, so file IO overlaps the next
            # chunk's encode while at most two chunks' buffers are alive.
            with timed_phase(phase_times, "encode+write/wait"):
                for f in pending_futures:
                    f.result()
            pending_futures = chunk_futures
            node_start = node_end
    with timed_phase(phase_times, "encode+write/wait"):
        for f in pending_futures:
            f.result()
    return recorded


def _meta_proto(
    resolution: float, bounding_box: Aabb, nodes: List[Tuple[NodeId, int]]
) -> MetaProto:
    root_cube_edge = Cube.bounding(bounding_box).edge_length
    node_protos = []
    for node_id, count in sorted(nodes, key=lambda t: t[0].value):
        edge = root_cube_edge / (1 << node_id.level)
        node_protos.append(
            OctreeNodeProto(
                id=node_id.value,
                num_points=count,
                position_encoding=position_encoding_for(edge, resolution).to_proto(),
            )
        )
    return MetaProto(
        version=CURRENT_VERSION,
        bounding_box=BoundingBoxProto(
            min=tuple(bounding_box.mins), max=tuple(bounding_box.maxs)
        ),
        octree=OctreeMetaProto(resolution=resolution, nodes=node_protos),
    )


def build_octree_from_file(
    output_directory: str,
    resolution: float,
    filename: str,
    attributes: Optional[Sequence[str]] = None,
    use_device: bool = True,
    mesh=None,
    phase_times: Optional[dict] = None,
    device="cuda",
) -> BuildResult:
    """PLY file -> octree directory (reference: generation.rs:272-287)."""
    from ..io.ply import PlyReader

    with timed_phase(phase_times, "read ply"):
        batch = PlyReader(filename).read_all()
    return build_octree(
        output_directory, resolution, batch, attributes=attributes,
        use_device=use_device, mesh=mesh, phase_times=phase_times,
        device=device,
    )
