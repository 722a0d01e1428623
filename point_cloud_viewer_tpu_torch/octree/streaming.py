"""Out-of-core octree build on a PyTorch device: clouds larger than RAM.

Port of point_cloud_viewer_tpu/octree/streaming.py.  The in-core build
needs ~90 bytes/point of headroom; this module bounds memory by an
external Morton bucket partition:

1. PASS 1 streams the input once for the bounding box;
2. PASS 2 streams batches, Morton-encodes them and spills each point to
   one of 8^B bucket files by its code's top 3B bits (buckets are level-B
   subtrees, so no tree work crosses a bucket);
3. each bucket is loaded, its subtree is derived (on the device with
   `use_device`) rooted at the bucket's level-B node, and everything below
   level B is written; the bucket root's residual (what survives promotion
   into it) is kept;
4. the shallow top (levels <= B) is finished on the host from the
   residuals.

Output is byte-identical to the in-core build, and the spill marker, the
`_done_b*.json/.npz` checkpoint records and the octree bytes have the JAX
package's formats: a spill directory checkpointed by either package
resumes in the other.

Device pipeline (streaming.py:374-455): one bucket's derivation is kept in
flight while the host finishes the bucket before it.  On CUDA the upload
(pinned, non-blocking) and the derivation run on a stream of their own
(one a card for the process, `_pipeline_stream`) and never make the host
wait (ops/tree_build.py); an event recorded after the
launches is what `_finish_device_bucket` waits on before it fetches, on
the current stream, into pinned buffers.  Completion is FIFO, so the bytes
written and the checkpoint order are those of the sequential order.
`phase_times` keeps the JAX package's keys, plus `buckets_derived`,
`bucket_device_wait` and (CUDA) `bucket_device_busy`, `bounds` (PASS 1,
the span `build.bounds`) and the `encode+write/encode`, `/wait` and
`/write` of every `_write_levels` call, summed over the buckets and the
top.

Counters (`utils/progress.count`, recorded while a profiler runs):
`build.buckets`, the non-empty buckets loaded back from the spill (built
on the device or on the host, or handed whole to the top pass);
`build.bucket_points`, the points those loads held; `build.spill_bytes`,
the bytes appended to the spill files.

Two routes run the buckets one after another, as in the JAX package
(streaming.py:379, 523-628): the host build (`use_device=False`: native
tree_levels, or the numpy split discovery without the native library) and
deep builds past the 63-bit code budget, whose buckets sort on the device
with `use_device` and split their fat level-21 cells by re-rooted
sub-builds (builder._split_fat_leaves).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import native
from ..core.constants import META_FILENAME, MAX_POINTS_PER_NODE
from ..core.points_batch import PointsBatch, as_points_batch
from ..io.node_io import attempt_increasing_rlimit_to_max
from ..math.geometry import Aabb, Cube
from ..ops import morton
from ..utils.progress import count, timed_phase as _timed_phase
from .node_id import MAX_FORMAT_LEVEL, NodeId
from .builder import (
    BuildResult,
    _add,
    _group_subtree_levels,
    _group_subtree_levels_from_level_order,
    _LevelNodes,
    _meta_proto,
    _ranges_to_indices,
    _split_fat_leaves,
    _subsample_bottom_up,
    _write_levels,
    compute_depth_cap,
)


def _iter_batches(data) -> Iterator[PointsBatch]:
    batch = as_points_batch(data)
    if batch is not None:
        yield batch
    else:
        for b in data:
            yield as_points_batch(b)


# --- copied from point_cloud_viewer_tpu/octree/streaming.py:60-148 --------


class _BucketSpill:
    """Append-only per-bucket spill files (one .bin per array column)."""

    def __init__(self, directory: str, num_buckets: int) -> None:
        self.directory = directory
        self.num_buckets = num_buckets
        self.counts = np.zeros(num_buckets, dtype=np.int64)
        self._schemas: Optional[List[Tuple[str, np.dtype, int]]] = None

    def _path(self, bucket: int, name: str) -> str:
        return os.path.join(self.directory, f"b{bucket:04d}.{name}")

    def append(self, bucket_ids: np.ndarray, batch: PointsBatch) -> None:
        if self._schemas is None:
            self._schemas = [("position", np.dtype("<f8"), 3)] + [
                (k, np.dtype(v.dtype).newbyteorder("<"),
                 v.shape[1] if v.ndim == 2 else 1)
                for k, v in batch.attributes.items()
            ]
        if len(bucket_ids) == 0:  # e.g. a reader's trailing empty chunk
            return
        # Bucket ids span only 8^B values: one bincount pass gives both the
        # run boundaries AND feeds the native stable counting scatter —
        # identical order to a stable sort by id.
        counts = np.bincount(bucket_ids, minlength=self.num_buckets)
        order = native.counting_argsort(bucket_ids, counts)
        if order is None:  # no native library: stable numpy sort
            order = np.argsort(bucket_ids, kind="stable")
        uniq = np.flatnonzero(counts)
        ends = np.cumsum(counts[uniq])
        starts = ends - counts[uniq]
        arrays = {"position": batch.position, **batch.attributes}
        for b, s, e in zip(uniq, starts, ends):
            sel = order[s:e]
            for name, dt, _ in self._schemas:
                part = native.take_rows(arrays[name], sel)
                if part is None:
                    part = arrays[name][sel]
                if part.dtype != dt:
                    part = part.astype(dt)
                with open(self._path(int(b), name), "ab") as f:
                    part.tofile(f)
                count("build.spill_bytes", part.nbytes)
            self.counts[int(b)] += e - s

    def load(self, bucket: int) -> Optional[PointsBatch]:
        if self.counts[bucket] == 0:
            return None
        arrays = {}
        for name, dt, dim in self._schemas:
            raw = np.fromfile(self._path(bucket, name), dtype=dt)
            arrays[name] = raw.reshape(-1, dim) if dim > 1 else raw
        position = arrays.pop("position")
        count("build.buckets")
        count("build.bucket_points", len(position))
        return PointsBatch(position=position, attributes=arrays)

    def delete(self, bucket: int) -> None:
        for name, _, _ in self._schemas or []:
            try:
                os.remove(self._path(bucket, name))
            except FileNotFoundError:
                pass


_SPILL_MARKER = "_spill_complete.json"


def _checkpoint_params(resolution, bounding_box, b_levels, depth_cap,
                       attributes, total_cap) -> dict:
    return {
        "resolution": float(resolution),
        "bbox_min": [float(v) for v in bounding_box.mins],
        "bbox_max": [float(v) for v in bounding_box.maxs],
        "bucket_levels": int(b_levels),
        "depth_cap": int(depth_cap),
        "total_cap": int(total_cap),
        "attributes": sorted(attributes) if attributes is not None else None,
    }


def _bucket_done_paths(spill_dir: str, bucket: int):
    base = os.path.join(spill_dir, f"_done_b{bucket:04d}")
    return base + ".json", base + ".npz"


# --- the build (mirrors streaming.py:151-475) ------------------------------


def build_octree_streaming(
    output_directory: str,
    resolution: float,
    data: Union[PointsBatch, Iterable[PointsBatch]],
    bounding_box: Optional[Aabb] = None,
    attributes: Optional[Sequence[str]] = None,
    bucket_levels: int = 2,
    spill_directory: Optional[str] = None,
    use_device: bool = True,
    phase_times: Optional[dict] = None,
    device="cuda",
) -> BuildResult:
    """Bounded-memory build: peak RAM ~ the largest bucket (~N/8^B for
    spatially spread data) instead of the whole cloud.

    `data` may be a PointsBatch or any iterator of batches (e.g. PlyReader);
    for iterator input, `bounding_box` must be supplied OR the iterator must
    be re-iterable (it is streamed twice).

    CHECKPOINT/RESUME: with an explicit `spill_directory`, the spill pass
    writes a completion marker and every finished bucket subtree persists
    its residual + recorded nodes before its spill files are deleted.
    Re-running the same call after a crash skips the spill pass and the
    finished buckets; the result is byte-identical to an uninterrupted
    build.

    `use_device`: each bucket's subtree derivation (sort + leaf assignment
    + LOD promotion) runs on `device` ("cuda", or "cpu" for the kernels'
    plain PyTorch versions); codes go up at 8 B/pt, the grouped exchange
    comes down at ~4 B/pt.  In a deep build (total cap > 21) the device
    sorts each bucket and derives its fat cells of at least
    builder._DEEP_DEVICE_MIN_N points.  False is the host build, which
    ignores `device`.
    `phase_times` accumulates wall seconds per phase and the bytes moved
    (`bucket_upload_bytes`, `bucket_fetch_bytes`)."""
    from ..device import resolve_device

    dev = resolve_device(device) if use_device else None
    attempt_increasing_rlimit_to_max()
    os.makedirs(output_directory, exist_ok=True)

    if (
        bounding_box is None
        and as_points_batch(data) is None
        and iter(data) is data
    ):
        # A one-shot iterator would be exhausted by the bbox pass and the
        # spill pass would then see nothing — a silently empty octree.
        raise ValueError(
            "data is a one-shot iterator: pass bounding_box= explicitly or "
            "provide a re-iterable input (the stream is read twice)"
        )

    # --- PASS 1: the bounding box ------------------------------------------
    if bounding_box is None:
        with _timed_phase(phase_times, "bounds"):
            if as_points_batch(data) is not None:
                bounding_box = Aabb.bounding_points(data.position)
            else:
                for b in _iter_batches(data):
                    if attributes is not None and bounding_box is None:
                        # First batch: fail a typo'd attribute name before the
                        # (potentially hours-long) bbox + spill passes.
                        missing = [a for a in attributes if a not in b.attributes]
                        if missing:
                            raise ValueError(
                                f"requested attributes not in input: {missing}"
                            )
                    bb = Aabb.bounding_points(b.position)
                    if bounding_box is None:
                        bounding_box = bb
                    else:
                        bounding_box.grow(bb.mins)
                        bounding_box.grow(bb.maxs)
                if bounding_box is None:
                    bounding_box = Aabb.zero()
    root_cube = Cube.bounding(bounding_box)

    # total_cap past the u64 budget (21) = a deep build: fat level-21
    # cells are split further inside each bucket subtree by re-rooted
    # sub-builds, exactly as the in-core builder does (_split_fat_leaves).
    total_cap = compute_depth_cap(
        root_cube.edge_length, resolution, max_level=MAX_FORMAT_LEVEL
    )
    depth_cap = min(total_cap, morton.MAX_DEPTH)
    b_levels = min(bucket_levels, depth_cap - 1)
    num_buckets = 8**b_levels

    spill_dir = spill_directory or tempfile.mkdtemp(prefix="octree_spill_")
    os.makedirs(spill_dir, exist_ok=True)
    spill = _BucketSpill(spill_dir, num_buckets)

    params = _checkpoint_params(
        resolution, bounding_box, b_levels, depth_cap, attributes, total_cap
    )
    marker_path = os.path.join(spill_dir, _SPILL_MARKER)
    resumed = False
    if spill_directory is not None and os.path.exists(marker_path):
        try:
            with open(marker_path) as f:
                marker = json.load(f)
        except (json.JSONDecodeError, OSError):
            marker = {}  # truncated by a crash mid-write: clean slate below
        marker_params = marker.get("params")
        if (
            isinstance(marker_params, dict)
            and "total_cap" not in marker_params
            and params["total_cap"] == params["depth_cap"]
        ):
            # Checkpoint written before total_cap existed: such builds
            # were always non-deep (total_cap == depth_cap), so a legacy
            # marker whose other params match is the SAME build.
            marker_params = {**marker_params, "total_cap": params["depth_cap"]}
        if marker_params == params:
            # Resume: the spill pass already completed for this exact build.
            total = int(marker["total"])
            spill.counts = np.asarray(marker["counts"], dtype=np.int64)
            spill._schemas = [
                (name, np.dtype(dt), int(dim))
                for name, dt, dim in marker["schemas"]
            ]
            resumed = True
        elif "params" in marker:
            raise ValueError(
                f"spill directory {spill_dir} holds a checkpoint for a "
                "DIFFERENT build (params mismatch); use a fresh directory"
            )
        # else: corrupt/unparseable marker == no checkpoint -> clean slate.

    # --- PASS 2: spill by top bucket bits ----------------------------------
    if not resumed:
        # A crash DURING a previous spill pass leaves partial append-only
        # bucket files with no marker; appending onto them would duplicate
        # points.  Start from a clean slate, removing only our own files.
        ours = re.compile(r"^(b\d{4,}\..+|_done_b\d{4,}\.(json|npz))$")
        for name in os.listdir(spill_dir):
            if ours.match(name) or name == _SPILL_MARKER:
                try:
                    os.remove(os.path.join(spill_dir, name))
                except OSError:
                    pass
        total = 0
        with _timed_phase(phase_times, "spill"):
            for batch in _iter_batches(data):
                if attributes is not None:
                    missing = [a for a in attributes if a not in batch.attributes]
                    if missing:
                        raise ValueError(
                            f"requested attributes not in input: {missing}"
                        )
                    batch = PointsBatch(
                        position=batch.position,
                        attributes={a: batch.attributes[a] for a in attributes},
                    )
                codes, _ = morton.quantize_and_encode(
                    batch.position, root_cube.min, root_cube.edge_length,
                    depth_cap,
                )
                buckets = (
                    codes >> np.uint64(3 * (depth_cap - b_levels))
                ).astype(np.int64)
                spill.append(buckets, batch)
                total += len(batch)
        if spill_directory is not None:
            # Atomic: a crash mid-write must not leave truncated JSON.
            tmp = marker_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({
                    "params": params,
                    "total": total,
                    "counts": [int(c) for c in spill.counts],
                    "schemas": [
                        (name, dt.str, int(dim))
                        for name, dt, dim in (spill._schemas or [])
                    ],
                }, f)
            os.replace(tmp, marker_path)

    if total == 0:
        meta = _meta_proto(resolution, bounding_box, [])
        with open(os.path.join(output_directory, META_FILENAME), "wb") as f:
            f.write(meta.encode())
        shutil.rmtree(spill_dir, ignore_errors=True)
        return BuildResult(output_directory, root_cube, resolution, bounding_box, [], 0)

    # --- top structure from aggregated bucket counts -----------------------
    top_leaf_of_bucket, split_b = top_structure(
        spill.counts, b_levels, root_cube, resolution, depth_cap
    )

    # --- per-bucket subtree builds -----------------------------------------
    checkpointing = spill_directory is not None
    recorded: List[Tuple[NodeId, int]] = []
    # (level, batch) pairs feeding the top pass: bucket residuals at level B
    # and whole point sets of shallow leaves.
    top_inputs: List[Tuple[int, PointsBatch]] = []

    def _record_bucket(bkt: int, residual: PointsBatch, nodes) -> None:
        recorded.extend(nodes)
        top_inputs.append((b_levels, residual))
        if checkpointing:
            # Persist residual + recorded nodes BEFORE deleting the spill:
            # a crash in between just reprocesses this bucket.
            dj, dn = _bucket_done_paths(spill_dir, bkt)
            with open(dn + ".tmp", "wb") as f:
                np.savez(
                    f, position=residual.position,
                    **{f"attr_{k}": v for k, v in residual.attributes.items()},
                )
            os.replace(dn + ".tmp", dn)
            tmp = dj + ".tmp"
            with open(tmp, "w") as f:
                json.dump(
                    {"nodes": [[str(nid.value), c] for nid, c in nodes]}, f
                )
            os.replace(tmp, dj)  # json presence = record complete
        spill.delete(bkt)

    # Device pipelining (non-deep builds, streaming.py:374-379): one
    # bucket's derivation in flight ahead of the bucket being finished, on
    # one stream for every bucket's upload + derivation (None on the CPU).
    pipeline_device = use_device and total_cap == depth_cap
    stream = (_pipeline_stream(dev)
              if pipeline_device and dev.type == "cuda" else None)
    inflight: List[Tuple[int, PointsBatch, tuple]] = []

    def _complete_oldest() -> None:
        bkt, bbatch, state = inflight.pop(0)
        residual, nodes = _finish_device_bucket(
            output_directory, bbatch, state, root_cube, resolution,
            depth_cap, b_levels, phase_times,
        )
        _record_bucket(bkt, residual, nodes)

    for bucket in range(num_buckets):
        if spill.counts[bucket] == 0:
            continue
        leaf_lvl = int(top_leaf_of_bucket[bucket])
        if leaf_lvl >= 0 or bucket not in split_b:
            # No subtree work: the whole bucket feeds the top pass.  Its
            # spill files stay until the very end when checkpointing (the
            # top pass is redone on resume).
            bucket_batch = spill.load(bucket)
            if not checkpointing:
                spill.delete(bucket)
            top_inputs.append(
                (leaf_lvl if leaf_lvl >= 0 else b_levels, bucket_batch)
            )
            continue

        done_json, done_npz = _bucket_done_paths(spill_dir, bucket)
        done_valid = False
        if checkpointing and os.path.exists(done_json):
            try:
                with open(done_json) as f:
                    done = json.load(f)
                done_valid = True
            except (json.JSONDecodeError, OSError):
                done_valid = False  # crashed mid-write: rebuild this bucket
        if done_valid:
            # Resume: this bucket's subtree is already on disk.
            recorded.extend(
                (NodeId(int(v)), int(c)) for v, c in done["nodes"]
            )
            payload = np.load(done_npz)
            residual = PointsBatch(
                position=payload["position"],
                attributes={
                    k[5:]: payload[k]
                    for k in payload.files if k.startswith("attr_")
                },
            )
            top_inputs.append((b_levels, residual))
            continue

        with _timed_phase(phase_times, "bucket_load"):
            bucket_batch = spill.load(bucket)
        if pipeline_device:
            state = _dispatch_device_bucket(
                bucket_batch, root_cube, depth_cap, b_levels, phase_times,
                dev, stream,
            )
            inflight.append((bucket, bucket_batch, state))
            if len(inflight) > 1:
                _complete_oldest()
            continue
        residual, nodes = _build_bucket_subtree(
            output_directory, bucket_batch, bucket, b_levels, root_cube,
            resolution, depth_cap, total_cap, dev, phase_times,
        )
        _record_bucket(bucket, residual, nodes)
    while inflight:
        _complete_oldest()

    # --- shallow top: levels b_levels..0 ------------------------------------
    with _timed_phase(phase_times, "top"):
        top_nodes = _finish_top(
            output_directory, top_inputs, root_cube, resolution, depth_cap,
            phase_times,
        )
    recorded.extend(top_nodes)

    meta = _meta_proto(resolution, bounding_box, recorded)
    with open(os.path.join(output_directory, META_FILENAME), "wb") as f:
        f.write(meta.encode())
    # Success: the checkpoint is only cleared now, so a crash anywhere
    # above (the top pass and meta write included) resumes.
    shutil.rmtree(spill_dir, ignore_errors=True)
    return BuildResult(
        output_directory, root_cube, resolution, bounding_box, recorded, total_cap
    )


# --- copied from point_cloud_viewer_tpu/octree/streaming.py:478-520 -------


def top_structure(
    bucket_counts: np.ndarray,
    b_levels: int,
    root_cube: Cube,
    resolution: float,
    depth_cap: int,
) -> Tuple[np.ndarray, set]:
    """Exact split structure for levels 0..B from per-level-B-cell point
    counts: a node above the bucket level may itself be a leaf, so decide
    splits from the (exact) aggregated counts the way the in-memory builder
    would.  Returns (top_leaf_of_bucket (8^B,) int64 — the shallow leaf
    level covering each bucket, -1 where the bucket's level-B node splits
    further — and split_b, the set of level-B paths that split)."""
    num_buckets = 8**b_levels
    top_leaf_of_bucket = np.full(num_buckets, -1, dtype=np.int64)  # leaf level
    split = {0: np.zeros(1, dtype=np.uint64)}  # root always splits
    level_counts = {
        lvl: np.add.reduceat(
            bucket_counts, np.arange(0, num_buckets, 8 ** (b_levels - lvl))
        )
        for lvl in range(b_levels + 1)
    }
    for lvl in range(1, b_levels + 1):
        parent_split = split[lvl - 1]
        children = (parent_split[:, None] << np.uint64(3)) | np.arange(8, dtype=np.uint64)
        children = children.ravel()
        counts = level_counts[lvl][children.astype(np.int64)]
        nonempty = counts > 0
        edge = root_cube.edge_length / (1 << lvl)
        can_split = lvl < depth_cap and edge > resolution
        is_leaf = nonempty & ((counts <= MAX_POINTS_PER_NODE) | (not can_split))
        # Mark buckets under each leaf.
        for path in children[is_leaf]:
            span = 8 ** (b_levels - lvl)
            start = int(path) * span
            top_leaf_of_bucket[start : start + span] = lvl
        split[lvl] = children[nonempty & ~is_leaf]
    split_b = set(int(p) for p in split.get(b_levels, []))
    return top_leaf_of_bucket, split_b


# --- the sequential bucket (mirrors streaming.py:523-628) -----------------


def _build_bucket_subtree(
    output_directory: str,
    batch: PointsBatch,
    bucket_path: int,
    bucket_level: int,
    root_cube: Cube,
    resolution: float,
    depth_cap: int,
    total_cap: int,
    device: Optional[torch.device],
    phase_times: Optional[dict],
) -> Tuple[PointsBatch, List[Tuple[NodeId, int]]]:
    """Build the subtree under one level-B node of a host or deep build:
    writes all nodes at levels > B, returns the bucket node's residual
    points (its post-promotion content, NOT yet written — the top pass
    promotes out of it).

    `device` (None: the host build) sorts the bucket; total_cap >
    depth_cap marks a DEEP build: fat level-depth_cap cells inside this
    bucket are split by re-rooted sub-builds (builder._split_fat_leaves,
    on `device` for cells of at least _DEEP_DEVICE_MIN_N points) and the
    bucket derivation then splits by the RAW counts while slicing the
    reduced arrays, exactly like the in-core deep path."""
    from ..ops.tree_build import argsort_codes_on_device

    n = len(batch)
    with _timed_phase(phase_times, "bucket_quantize"):
        codes, _ = morton.quantize_and_encode(
            batch.position, root_cube.min, root_cube.edge_length, depth_cap
        )
    with _timed_phase(phase_times, "bucket_sort"):
        if device is not None:
            codes, order = argsort_codes_on_device(codes, device)
        else:
            codes, order = morton.argsort_codes(codes)

    if total_cap > depth_cap:
        raw_codes = codes
        codes, order, deep_nodes = _split_fat_leaves(
            output_directory, codes, order, batch, root_cube, resolution,
            depth_cap, total_cap, device=device, phase_times=phase_times,
        )
        levels = _discover_subtree_levels(
            codes, len(codes), depth_cap, root_cube.edge_length, resolution,
            bucket_path, bucket_level, raw_codes=raw_codes,
        )
        final_nodes = _subsample_bottom_up(levels, stop_level=bucket_level)
        residual_idx = (
            final_nodes.pop(bucket_level).idx
            if bucket_level in final_nodes
            else np.empty(0, dtype=np.int64)
        )
        nodes = _write_levels(
            output_directory, final_nodes, batch, order, root_cube,
            resolution, phase_times=phase_times,
        )
        nodes.extend(deep_nodes)
        return batch.take(order[residual_idx]), nodes

    with _timed_phase(phase_times, "bucket_derive"):
        out = native.tree_levels(
            codes, depth_cap, depth_cap, MAX_POINTS_PER_NODE,
            root_level=bucket_level, stop_level=bucket_level,
        )
        if out is not None:
            leaf_lv, final_lv = out
            final_nodes, residual_idx = _group_subtree_levels(
                codes, final_lv, leaf_lv, depth_cap, bucket_level
            )
        else:
            # Discover splits INSIDE the bucket: start from the bucket node
            # itself; promotion stops AT the bucket level, whose
            # accumulated (pre-promotion) list is the residual.
            levels = _discover_subtree_levels(
                codes, n, depth_cap, root_cube.edge_length, resolution,
                bucket_path, bucket_level,
            )
            final_nodes = _subsample_bottom_up(levels, stop_level=bucket_level)
            residual_idx = (
                final_nodes.pop(bucket_level).idx
                if bucket_level in final_nodes
                else np.empty(0, dtype=np.int64)
            )
    with _timed_phase(phase_times, "bucket_encode_write"):
        nodes = _write_levels(
            output_directory, final_nodes, batch, order, root_cube,
            resolution, phase_times=phase_times,
        )
    return batch.take(order[residual_idx]), nodes


# --- the device bucket pipeline (mirrors streaming.py:631-746) -------------

# The pipeline's stream, one a card for the process.  The caching allocator
# keeps a freed block for the stream it was made on; with a new stream a
# build (torch.cuda.Stream hands out the next of a pool of 32), the first
# bucket of every build allocated its device memory anew, and those
# allocations held the host in the bucket's dispatch.
_PIPELINE_STREAMS: Dict[str, "torch.cuda.Stream"] = {}


def _pipeline_stream(device: torch.device) -> "torch.cuda.Stream":
    key = str(torch.device("cuda", torch.cuda.current_device())
              if device.index is None else device)
    if key not in _PIPELINE_STREAMS:
        _PIPELINE_STREAMS[key] = torch.cuda.Stream(device)
    return _PIPELINE_STREAMS[key]


def _dispatch_device_bucket(
    batch: PointsBatch,
    root_cube: Cube,
    depth_cap: int,
    bucket_level: int,
    phase_times: Optional[dict],
    device: torch.device,
    stream: Optional["torch.cuda.Stream"],
) -> tuple:
    """Quantize + launch one bucket's device derivation WITHOUT waiting:
    returns (codes_unsorted, the device GroupedExchange, and on CUDA the
    events recorded before the upload and after the launches, else
    None)."""
    from ..ops.tree_build import tree_codes_grouped_on_device

    with _timed_phase(phase_times, "bucket_quantize"):
        codes_unsorted, _ = morton.quantize_and_encode(
            batch.position, root_cube.min, root_cube.edge_length, depth_cap
        )
    with _timed_phase(phase_times, "bucket_device_dispatch"):
        with torch.cuda.stream(stream):
            events = None
            if stream is not None:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record(stream)
            out = tree_codes_grouped_on_device(
                codes_unsorted, depth_cap, depth_cap,
                root_level=bucket_level, stop_level=bucket_level,
                device=device,
            )
            if events is not None:
                events[1].record(stream)
    _add(phase_times, "buckets_derived", 1)
    _add(phase_times, "bucket_upload_bytes", codes_unsorted.nbytes)
    return codes_unsorted, out, events


def _finish_device_bucket(
    output_directory: str,
    batch: PointsBatch,
    state: tuple,
    root_cube: Cube,
    resolution: float,
    depth_cap: int,
    bucket_level: int,
    phase_times: Optional[dict],
) -> Tuple[PointsBatch, List[Tuple[NodeId, int]]]:
    """Wait for a dispatched bucket derivation, fetch it, then group +
    encode + write its subtree (host side).

    Fast path: order2 (4 B/pt) + per-level counts + the 1-point-leaf
    extras, grouped from run boundaries on the host.  Fallback (extras
    overflow): the classic (idx, final, leaf) arrays.  The host's time
    blocked on the event is `bucket_device_wait`, a part of
    `bucket_device_derive`; on CUDA, `bucket_device_busy` adds the card's
    time from upload to the derivation's end, so wait / busy is the share
    of device work the host did not hide."""
    from ..ops.tree_build import fetch_grouped

    codes_unsorted, out, events = state
    with _timed_phase(phase_times, "bucket_device_derive"):
        with _timed_phase(phase_times, "bucket_device_wait"):
            if events is not None:
                events[1].synchronize()
        got = fetch_grouped(out)
        del out
    if events is not None:
        _add(phase_times, "bucket_device_busy",
             events[0].elapsed_time(events[1]) / 1e3)
    _add(phase_times, "bucket_fetch_bytes", got.nbytes)
    with _timed_phase(phase_times, "bucket_group"):
        if got.overflow:
            order = got.idx
            final_nodes, residual_idx = _group_subtree_levels(
                codes_unsorted[order], got.final, got.leaf, depth_cap,
                bucket_level,
            )
        else:
            order = got.order2
            final_nodes, residual_idx = _group_subtree_levels_from_level_order(
                codes_unsorted, order, got.level_counts, got.extras_idx,
                got.extras_level, depth_cap, bucket_level,
            )
    with _timed_phase(phase_times, "bucket_encode_write"):
        nodes = _write_levels(
            output_directory, final_nodes, batch, order, root_cube,
            resolution, phase_times=phase_times,
        )
    return batch.take(order[residual_idx]), nodes


# --- copied from point_cloud_viewer_tpu/octree/streaming.py:749-849 -------


def _discover_subtree_levels(
    codes, n, depth_cap, root_edge, resolution, bucket_path, bucket_level,
    raw_codes=None,
) -> Dict[int, _LevelNodes]:
    """Like builder._discover_levels but rooted at the level-B bucket node
    (which is treated as split unconditionally; its residual is handled by
    the top pass), over SORTED codes.

    `raw_codes` (deep builds): split decisions come from counts over the
    PRE-reduction codes — an ancestor of a fat cell must split even when
    its sub-build residual is small (builder._discover_levels_deep
    semantics at bucket scope) — while point lists slice `codes`."""
    leaf_acc: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    split_paths = np.array([bucket_path], dtype=np.uint64)
    split_ends = np.full(1, n, dtype=np.int64)

    for level in range(bucket_level + 1, depth_cap + 1):
        k = len(split_paths)
        shift = np.uint64(3 * (depth_cap - level))
        child_paths = (split_paths[:, None] << np.uint64(3)) | np.arange(8, dtype=np.uint64)
        bounds = child_paths << shift
        starts = np.searchsorted(codes, bounds.ravel(), side="left").astype(np.int64)
        ends = np.concatenate(
            [starts.reshape(k, 8)[:, 1:], split_ends[:, None]], axis=1
        ).ravel()
        if raw_codes is None:
            counts = ends - starts
        else:
            upper = bounds + (np.uint64(1) << shift)
            counts = (
                np.searchsorted(raw_codes, upper.ravel(), side="left")
                - np.searchsorted(raw_codes, bounds.ravel(), side="left")
            )
        nonempty = counts > 0
        edge = root_edge / (1 << level)
        can_split = level < depth_cap and edge > resolution
        is_leaf = nonempty & (counts <= MAX_POINTS_PER_NODE) if can_split else nonempty
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
        out[level] = _LevelNodes(
            paths=paths,
            offsets=np.concatenate([[0], np.cumsum(counts)]),
            idx=_ranges_to_indices(ranges),
        )
    return out


def _finish_top(
    output_directory: str,
    top_inputs: List[Tuple[int, PointsBatch]],
    root_cube: Cube,
    resolution: float,
    depth_cap: int,
    phase_times: Optional[dict] = None,
) -> List[Tuple[NodeId, int]]:
    """Finish the shallow levels: inputs are (node_level, points) pairs —
    bucket residuals at the bucket level and whole shallow-leaf point sets.
    Promotion then proceeds upward exactly like the in-memory builder."""
    top_inputs = [(lvl, b) for lvl, b in top_inputs if len(b)]
    if not top_inputs:
        return []
    top = PointsBatch.concatenate([b for _, b in top_inputs])
    node_levels = np.concatenate(
        [np.full(len(b), lvl, dtype=np.int64) for lvl, b in top_inputs]
    )
    codes, _ = morton.quantize_and_encode(
        top.position, root_cube.min, root_cube.edge_length, depth_cap
    )
    codes, order = morton.argsort_codes(codes)
    node_levels = node_levels[order]

    level_nodes: Dict[int, _LevelNodes] = {}
    for lvl in np.unique(node_levels):
        lvl = int(lvl)
        sel = np.nonzero(node_levels == lvl)[0]
        prefixes = codes[sel] >> np.uint64(3 * (depth_cap - lvl))
        paths, counts = np.unique(prefixes, return_counts=True)
        level_nodes[lvl] = _LevelNodes(
            paths=paths.astype(np.uint64),
            offsets=np.concatenate([[0], np.cumsum(counts)]),
            idx=sel.astype(np.int64),
        )
    final_nodes = _subsample_bottom_up(level_nodes)
    return _write_levels(
        output_directory, final_nodes, top, order, root_cube, resolution,
        phase_times=phase_times,
    )
