"""Sharded octree building over a mesh of PyTorch devices: Morton-prefix
partitioning with one all-to-all exchange (port of point_cloud_viewer_tpu/
parallel/sharded_build.py).

The JAX package runs each step as one SPMD program under `shard_map`.
Here one thread drives the mesh (parallel/mesh.py) through the same three
parts, each queued on every shard's device before the next begins:

1. per source shard: Morton-encode (or take) its codes, sort them with
   their global point index, bucket the sorted rows by owner shard and
   pack one capacity-sized block per destination;
2. `all_to_all`: destination d receives block d of every source, in
   source order;
3. per destination shard: sort what it received.  Every shard now owns a
   disjoint, globally sorted code range; the tree step derives its
   points' leaf and final levels there (K6 and K4 on the card), with no
   further exchange.

Between 2 and 3 the host reads how many rows each destination received
(one integer a shard), so part 3 works on the real rows only.

Codes are non-negative int64 (63 bits at depth 21), so none of the JAX
sentinels fits: its host pad code 2^(3 depth) needs 64 bits and its fill
(hi = lo = 0xFFFFFFFF) is -1 as int64, which sorts first.  The port counts
instead: host pads are rows past a shard's `n_real` (the tree step) or
dropped by index (`order >= n`, the sort, as sharded_build.py:299-302),
and capacity fill is the rows past each block's kept count.  Where the
JAX package breaks ties on the point index, a stable sort of rows laid
out in index order gives the same order: each shard's rows are in index
order, and the blocks of a destination arrive in source order, whose
index ranges ascend.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops import morton
from .mesh import Mesh, replicate, shard

# Index and code of a capacity-fill slot; never read past the kept count.
_FILL = -1


def all_to_all(send: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """`jax.lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=True)`
    over the mesh (sharded_build.py:105-110): send[s] is shard s's (n, cap,
    ...) tensor on mesh[s]; returns recv[d], the concatenation over s of
    send[s][d], an (n * cap, ...) tensor on mesh[d].  Each block is one
    copy (card to card: a peer copy, non-blocking); a block that stays on
    its device is not copied before the concatenation."""
    n = len(mesh)
    if len(send) != n:
        raise ValueError(f"{len(send)} send tensors for {n} shards")
    recv = []
    for d, dev in enumerate(mesh):
        blocks = []
        for s in range(n):
            block = send[s][d]
            both_cuda = block.device.type == "cuda" and dev.type == "cuda"
            blocks.append(block.to(dev, non_blocking=both_cuda))
        recv.append(torch.cat(blocks))
    return recv


def _slice_bucket(codes: torch.Tensor, depth: int, n_shards: int):
    """Owner shard of each sorted code: equal slices of the code range
    (sharded_build.py:77-82, 185-192).  Non-decreasing in the code."""
    if n_shards == 1:
        return torch.zeros_like(codes)
    hi_range = 1 << max(3 * depth - 32, 1)
    slice_size = max(-(-hi_range // n_shards), 1)
    hi = codes >> 32  # code bits 32..62, the JAX hi word
    return torch.div(hi, slice_size, rounding_mode="floor").clamp_max(
        n_shards - 1)


def _pack(bucket: torch.Tensor, capacity: int, n_shards: int,
          columns: Sequence[torch.Tensor], fills: Sequence):
    """Scatter-free packing (sharded_build.py:84-102): block j, slot c <-
    sorted row offsets[j] + c for c < kept[j], else the column's fill.
    `bucket` is non-decreasing, so the block bounds come from a search,
    with no host read (torch.bincount reads its maximum on CUDA).
    -> (blocks (n, capacity, ...) per column, kept (n,), overflow (1,))."""
    dev = bucket.device
    p = bucket.shape[0]
    if p == 0:
        kept = torch.zeros(n_shards, dtype=torch.int64, device=dev)
        blocks = [torch.full((n_shards, capacity, *c.shape[1:]), fill,
                             dtype=c.dtype, device=dev)
                  for c, fill in zip(columns, fills)]
        return blocks, kept, torch.zeros(1, dtype=torch.int64, device=dev)
    bounds = torch.searchsorted(
        bucket, torch.arange(n_shards + 1, dtype=bucket.dtype, device=dev))
    counts = bounds[1:] - bounds[:-1]
    kept = counts.clamp_max(capacity)
    overflow = (counts - kept).sum().reshape(1)
    slot = torch.arange(capacity, device=dev)
    src = (bounds[:-1, None] + slot).clamp_max(p - 1)
    valid = slot < kept[:, None]
    blocks = []
    for c, fill in zip(columns, fills):
        v = c[src]
        mask = valid.reshape(valid.shape + (1,) * (v.dim() - 2))
        blocks.append(torch.where(mask, v, torch.full_like(v, fill)))
    return blocks, kept, overflow


def _exchange(mesh: Mesh, packed: list):
    """Part 2: exchange every column and the kept counts, then read on the
    host how many rows each destination received.  packed[s] = (blocks,
    kept, overflow) of source s -> (recv columns per destination, valid
    rows per destination (host ints), overflow per source (host ints))."""
    n_cols = len(packed[0][0])
    recv = [all_to_all([p[0][i] for p in packed], mesh)
            for i in range(n_cols)]
    recv_counts = all_to_all([p[1][:, None] for p in packed], mesh)
    valid = [int(c.sum()) for c in recv_counts]
    overflow = [int(p[2]) for p in packed]
    return recv, valid, overflow


def _globalize(codes: torch.Tensor, valid: int, *columns: torch.Tensor):
    """Sort what a shard received; fill (code -1) sorts first, so the
    `valid` real rows are the tail.  -> (codes, *columns) of those rows,
    each a fresh tensor (an aligned base for the kernels)."""
    sorted_codes, perm = torch.sort(codes, stable=True)
    start = codes.shape[0] - valid
    perm = perm[start:]
    return (sorted_codes[start:].clone(), *(c[perm] for c in columns))


# --- the exact distributed sort (sharded_build.py:152-303) -----------------


class ShardedCellSortResult(NamedTuple):
    """Per shard (lists over the mesh): its globally sorted, disjoint code
    range with the original point index carried through the exchange."""

    codes: list        # (valid,) int64 sorted codes
    index: list        # (valid,) int64 original point index
    valid_count: list  # host int: rows the shard owns
    overflow: list     # host int: rows the shard dropped for capacity


def make_sharded_cell_sort_step(
    mesh: Mesh,
    *,
    depth: int = morton.MAX_DEPTH,
    capacity_factor: float = 2.0,
):
    """Exact distributed Morton sort (sharded_build.py:162-238): step(
    cells, base_index) takes per-shard (p, 3) integer cell tensors (each on
    its mesh device, as `shard` gives them) and each shard's first global
    index, and returns a ShardedCellSortResult, bit-identical to the host
    sort over the rows kept."""
    n_shards = len(mesh)

    def step(cells: Sequence[torch.Tensor], base_index: Sequence[int]):
        p = cells[0].shape[0]
        capacity = max(8, int(np.ceil(capacity_factor * p / n_shards)))
        packed = []
        for s in range(n_shards):
            codes = morton.morton_encode_device(cells[s], depth)
            codes, perm = torch.sort(codes, stable=True)
            idx = perm + int(base_index[s])
            packed.append(_pack(_slice_bucket(codes, depth, n_shards),
                                capacity, n_shards, (codes, idx),
                                (_FILL, _FILL)))
        (r_codes, r_idx), valid, overflow = _exchange(mesh, packed)
        out = [_globalize(r_codes[d], valid[d], r_idx[d])
               for d in range(n_shards)]
        return ShardedCellSortResult([o[0] for o in out], [o[1] for o in out],
                                     valid, overflow)

    return step


def sharded_morton_sort(
    cells: np.ndarray,
    mesh: Mesh,
    depth: int,
    capacity_factor: float = 2.0,
    max_retries: int = 3,
    stats: Optional[dict] = None,
):
    """Host wrapper (sharded_build.py:241-303): distributed Morton sort of
    (N, 3) u32 cells over the mesh -> (codes_sorted u64 (N,), order int64
    (N,)), bit-identical to the host path.  Pads N to a multiple of the
    mesh size with the maximal cell, as the JAX package, and drops those
    rows by index; retries with doubled capacity while a bucket
    overflows.  `stats`, if given, records the attempt count, final
    capacity factor and last overflow."""
    n = len(cells)
    n_shards = len(mesh)
    if n == 0:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    padded = -(-n // n_shards) * n_shards
    per = padded // n_shards
    cells_padded = np.full((padded, 3), (1 << depth) - 1, dtype=np.uint32)
    cells_padded[:n] = cells
    on_mesh = shard(cells_padded.view(np.int32), mesh)
    base = [s * per for s in range(n_shards)]

    factor = capacity_factor
    attempts = 0
    for _ in range(max_retries):
        step = make_sharded_cell_sort_step(mesh, depth=depth,
                                           capacity_factor=factor)
        result = step(on_mesh, base)
        overflow = int(sum(result.overflow))
        attempts += 1
        if stats is not None:
            stats.update(attempts=attempts, final_factor=factor,
                         last_overflow=overflow)
        if overflow == 0:
            break
        factor *= 2.0
    else:
        raise RuntimeError("sharded sort capacity overflow after retries")

    codes = np.concatenate([c.cpu().numpy() for c in result.codes]).view(
        np.uint64)
    order = np.concatenate([i.cpu().numpy() for i in result.index])
    if padded != n:
        keep = order < n
        codes, order = codes[keep], order[keep]
    return codes, order


# --- the full distributed derivation (sharded_build.py:306-486) ------------


class ShardedTreeResult(NamedTuple):
    """Per shard (lists over the mesh), in globally sorted code order over
    the level-B subtrees the shard owns."""

    index: list        # (valid,) int64 original point index
    final_level: list  # (valid,) u8 post-promotion level
    leaf_level: list   # (valid,) u8 pre-promotion leaf level
    overflow: list     # host int a shard (always 0: capacity is exact)


def make_sharded_tree_step(
    mesh: Mesh,
    *,
    depth: int,
    b_levels: int,
    max_split_level: int,
    capacity: int,
    max_points_per_node: int,
):
    """The whole distributed derivation (sharded_build.py:317-407):
    step(codes, n_real, base_index, owner_table) takes per-shard int64
    codes (rows past n_real[s] are host pads, never read), each shard's
    first global index and the replicated owner table of the level-B
    cells.  After the exchange each shard owns whole level-B subtrees, so
    its leaf assignment and LOD promotion, stopped at level B, run there
    with no further exchange: one run of K6 and one of K4 a shard on the
    card.  What rests at level B is the residual the host's top pass
    finishes, as the out-of-core builder's buckets (octree/streaming.py).

    Reference analogue: the rayon scope that parallelizes the whole build,
    src/octree/generation.rs:152-193."""
    from ..ops.tree_build import _assign_and_promote

    n_shards = len(mesh)
    shift = 3 * (depth - b_levels)

    def step(codes: Sequence[torch.Tensor], n_real: Sequence[int],
             base_index: Sequence[int], owner_table: Sequence[torch.Tensor]):
        packed = []
        for s in range(n_shards):
            c, perm = torch.sort(codes[s][:int(n_real[s])], stable=True)
            idx = perm + int(base_index[s])
            owner = owner_table[s][c >> shift]
            packed.append(_pack(owner, capacity, n_shards, (c, idx),
                                (_FILL, _FILL)))
        (r_codes, r_idx), valid, overflow = _exchange(mesh, packed)
        index, final, leaf = [], [], []
        for d in range(n_shards):
            c, idx = _globalize(r_codes[d], valid[d], r_idx[d])
            if valid[d]:
                lv, fin = _assign_and_promote(
                    c, depth, max_split_level, max_points_per_node,
                    root_level=b_levels, stop_level=b_levels)
            else:
                lv = fin = torch.empty(0, dtype=torch.uint8, device=c.device)
            index.append(idx)
            final.append(fin)
            leaf.append(lv)
        return ShardedTreeResult(index, final, leaf, overflow)

    return step


def sharded_tree_levels(
    codes: np.ndarray,
    mesh: Mesh,
    depth: int,
    b_levels: int,
    max_split_level: int,
    max_points_per_node: int,
) -> list:
    """Host wrapper of the distributed derivation (sharded_build.py:410-
    486): (N,) u64 unsorted Morton codes -> per shard (order int64,
    final_level u8, leaf_level u8), each in globally sorted code order
    over the shard's level-B subtrees (shards concatenated = the global
    sorted order).

    The owner table is balanced from the exact per-cell counts (one host
    bincount), so the exchange's capacity is exact and no retry is needed.
    Each shard's arrays feed the host grouping and encode independently
    (octree/builder.py)."""
    n = len(codes)
    n_shards = len(mesh)
    if n >= 0xFFFFFFFF:
        raise ValueError("the sharded build caps at 2^32 - 1 points, as "
                         "the JAX package's u32 indices")
    if n == 0:
        return [(np.empty(0, np.int64), np.empty(0, np.uint8),
                 np.empty(0, np.uint8)) for _ in range(n_shards)]
    codes = morton.check_codes(codes)
    padded = -(-n // n_shards) * n_shards
    per = padded // n_shards
    codes_p = np.zeros(padded, dtype=np.uint64)
    codes_p[:n] = codes
    n_real = [int(np.clip(n - s * per, 0, per)) for s in range(n_shards)]

    num_buckets = 8**b_levels
    prefix = (codes >> np.uint64(3 * (depth - b_levels))).astype(np.int64)
    cell_counts = np.bincount(prefix, minlength=num_buckets)
    before = np.cumsum(cell_counts) - cell_counts
    owner_table = np.minimum((before * n_shards) // n, n_shards - 1)

    src_shard = np.arange(n) // per
    pair_counts = np.bincount(src_shard * n_shards + owner_table[prefix],
                              minlength=n_shards * n_shards)
    capacity = max(8, int(pair_counts.max()))

    step = make_sharded_tree_step(
        mesh, depth=depth, b_levels=b_levels,
        max_split_level=max_split_level, capacity=capacity,
        max_points_per_node=max_points_per_node,
    )
    result = step(shard(codes_p.view(np.int64), mesh), n_real,
                  [s * per for s in range(n_shards)],
                  replicate(owner_table.astype(np.int64), mesh))
    if sum(result.overflow):
        raise AssertionError("exact capacity overflowed")
    return [(i.cpu().numpy(), f.cpu().numpy(), lv.cpu().numpy())
            for i, f, lv in zip(result.index, result.final_level,
                                result.leaf_level)]


# --- the f32 stats step, the dry run's wiring profile (sharded_build.py:45-
# 160, 489-533) -------------------------------------------------------------


class ShardedSortResult(NamedTuple):
    """Per shard (lists over the mesh): its globally sorted code range and
    the f32 positions aligned with it."""

    codes: list        # (valid,) int64 sorted codes
    positions: list    # (valid, 3) f32
    valid_count: list  # host int: rows the shard owns
    overflow: list     # host int: rows the shard dropped for capacity


def _local_step(positions: Sequence[torch.Tensor],
                root_min: Sequence[torch.Tensor],
                root_edge: Sequence[torch.Tensor], mesh: Mesh, *,
                depth: int, capacity: int) -> ShardedSortResult:
    """sharded_build.py:55-131 over the mesh: quantize f32 positions,
    encode, sort carrying the positions, exchange, sort again.  The JAX
    2-key sort is unstable; this one keeps equal codes in index order."""
    n_shards = len(mesh)
    scale = float(1 << depth)
    packed = []
    for s in range(n_shards):
        pos = positions[s]
        t = (pos - root_min[s]) / root_edge[s]
        cells = torch.clamp(torch.floor(t * scale), 0.0, scale - 1.0)
        codes = morton.morton_encode_device(cells.to(torch.int64), depth)
        codes, pos = morton.sort_by_codes_device(codes, pos)
        packed.append(_pack(_slice_bucket(codes, depth, n_shards), capacity,
                            n_shards, (codes, pos), (_FILL, 0.0)))
    (r_codes, r_pos), valid, overflow = _exchange(mesh, packed)
    out = [_globalize(r_codes[d], valid[d], r_pos[d])
           for d in range(n_shards)]
    return ShardedSortResult([o[0] for o in out], [o[1] for o in out],
                             valid, overflow)


def _node_stats(codes: torch.Tensor, depth: int, level: int) -> torch.Tensor:
    """Non-empty level-`level` nodes in one shard's sorted codes
    (sharded_build.py:134-149): runs of equal code prefixes.  Summing over
    shards is exact while the prefix is at least the bucket's bits."""
    shift = 3 * (depth - level)
    if shift < 32:
        raise ValueError("stats_level too deep: need 3*(depth-level) >= 32")
    prefix = codes >> shift
    new_run = torch.ones_like(prefix, dtype=torch.bool)
    new_run[1:] = prefix[1:] != prefix[:-1]
    return new_run.sum()


def make_sharded_build_step(
    mesh: Mesh,
    *,
    depth: int = morton.MAX_DEPTH,
    capacity_factor: float = 2.0,
    stats_level: int = 3,
):
    """sharded_build.py:489-533: step(positions, root_min, root_edge) ->
    (ShardedSortResult, nodes at `stats_level` summed over the shards).
    `positions`: (N, 3) f32 (numpy or a tensor; sharded here) or the
    per-shard tensors `shard` gives.  The JAX psum is a sum on the host.
    The dry run's stats step; the exact builder never calls it."""
    n_shards = len(mesh)

    def step(positions, root_min, root_edge):
        if not isinstance(positions, (list, tuple)):
            positions = shard(positions, mesh)
        p_local = positions[0].shape[0]
        capacity = max(8, int(np.ceil(capacity_factor * p_local / n_shards)))
        result = _local_step(
            positions,
            replicate(torch.as_tensor(root_min, dtype=torch.float32), mesh),
            replicate(torch.as_tensor(root_edge, dtype=torch.float32), mesh),
            mesh, depth=depth, capacity=capacity,
        )
        total = sum(int(_node_stats(c, depth, stats_level))
                    for c in result.codes)
        return result, total

    return step
