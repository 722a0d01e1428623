"""Device core of the octree build: sorted Morton codes -> each point's leaf
level and final (post-LOD-promotion) level, and the grouped exchange the
host writes from.

Port of the device core of point_cloud_viewer_tpu/ops/tree_build.py.  The
rules are the JAX package's, unchanged:

* Leaf assignment: a point's leaf is the FIRST level whose cell holds
  <= MAX_POINTS_PER_NODE points (the reference's should_split rule,
  src/octree/generation.rs:128-150, re-derived per point).
* LOD promotion, deepest level first: among the points resting at a level,
  every 8th point of each node (rank % 8 == 0) moves to the parent
  (generation.rs:224-229).

Codes are non-negative int64 tensors (one 63-bit key per point) in place of
the JAX (hi, lo) uint32 pairs.  A stable `torch.sort` on that key gives the
order of JAX's unstable 3-key sort over (hi, lo, idx) (tree_build.py:460,
:608), because idx is unique.  On the card the leaf stage is one run of
K6 (ops/leaf_levels_cuda.leaf_stage: sorted codes -> boundary and leaf
levels), the promotion is one run of K4 over every level
(ops/level_cuda.promote_stage) and the extras rank runs through K1
(ops/scan_cuda); CPU tensors take their plain PyTorch versions, the leaf
stage its per-level K2 + K3 loop and the promotion its per-level K4 loop.

Between the upload and the fetch nothing reads the card from the host (no
`.item()`, no `bincount`, no test for an empty level), so a caller can
keep a derivation in flight while the host works (octree/streaming.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.constants import MAX_POINTS_PER_NODE
from . import morton
# _bound_levels lives beside the kernel that replaced it on the card; it is
# re-exported here, where the JAX package has it.
from .leaf_levels_cuda import _bound_levels, leaf_stage  # noqa: F401
from .level_cuda import promote_stage
from .scan_cuda import scan_1d

# Segment positions and permutations are int32, as in the JAX package.
_MAX_N = 2**31 - 1


def _assign_and_promote(codes: torch.Tensor, depth: int, max_split_level: int,
                        max_points_per_node: int, root_level: int = 0,
                        stop_level: int = 0, n_real: Optional[int] = None):
    """Sorted int64 codes -> (leaf_level, final_level) u8 per point.

    The fused formulation of tree_build.py:188-246: the leaf stage
    (boundary levels b and leaf levels, one K6 run on the card; on the CPU
    `_bound_levels` and per leaf level a K2 + K3 sweep), then the promotion
    stage (one K4 run over every level on the card; on the CPU one K4 sweep
    a level).  root_level/stop_level give the subtree
    semantics of the native tree_levels kernel: level-root segments split
    unconditionally (leaves live at levels root+1..max_split) and
    promotion stops at stop_level."""
    if not root_level <= stop_level <= max_split_level:
        raise ValueError("need root_level <= stop_level <= max_split_level")
    if root_level >= max_split_level:
        raise ValueError("need root_level < max_split_level")
    b, leaf = leaf_stage(codes, depth, max_split_level, max_points_per_node,
                         root_level, n_real)
    # Every level is swept: K4 on a level with no resident point changes
    # nothing, so the host never asks the card which levels are empty (the
    # lax.cond on jnp.any at tree_build.py:232 would be a host sync here).
    return leaf, promote_stage(b, leaf, max_split_level, stop_level)


def _check_codes(codes: torch.Tensor) -> None:
    if codes.dtype != torch.int64 or codes.dim() != 1:
        raise ValueError(f"codes must be a 1-D int64 tensor, got {codes.dtype} "
                         f"of shape {tuple(codes.shape)}")
    if codes.shape[0] > _MAX_N:
        raise ValueError(f"n = {codes.shape[0]} >= 2^31: segment positions "
                         "are int32")


def build_tree_device_codes(
    codes: torch.Tensor,  # (N,) int64 Morton codes (unsorted, < 2^63)
    depth: int,
    max_split_level: int,
    max_points_per_node: int = MAX_POINTS_PER_NODE,
    root_level: int = 0,
    stop_level: int = 0,
):
    """tree_build.py:439-465: -> (order int32 sorted -> original index,
    final u8, leaf u8), all in code-sorted order."""
    _check_codes(codes)
    sorted_codes, perm = torch.sort(codes, stable=True)
    leaf, cur = _assign_and_promote(sorted_codes, depth, max_split_level,
                                    max_points_per_node, root_level,
                                    stop_level)
    return perm.to(torch.int32), cur, leaf


class GroupedExchange(NamedTuple):
    """Outputs of build_tree_device_codes_grouped, in the JAX tuple order."""

    order2: torch.Tensor        # (N,) int32, sorted by (final level, code)
    level_counts: torch.Tensor  # (max_split_level+2,) int32; last bin = pads
    extras_idx: torch.Tensor    # (extras_cap,) int32 original indices
    extras_level: torch.Tensor  # (extras_cap,) u8 leaf levels
    extras_total: torch.Tensor  # 0-d int32: number of 1-point leaves
    idx: torch.Tensor           # (N,) int32 code-sorted -> original index
    final: torch.Tensor         # (N,) u8 final level, code-sorted order
    leaf: torch.Tensor          # (N,) u8 leaf level, code-sorted order


def build_tree_device_codes_grouped(
    codes: torch.Tensor,  # (N,) int64 Morton codes (unsorted, < 2^63)
    n_real: int,          # rows [n_real:] are pad rows
    depth: int,
    max_split_level: int,
    max_points_per_node: int = MAX_POINTS_PER_NODE,
    root_level: int = 0,
    stop_level: int = 0,
    extras_cap: int = 512,
) -> GroupedExchange:
    """tree_build.py:565-660, the grouped exchange: `order2` (the
    permutation sorted by final level, stable by code), per-level counts,
    and the 1-point-leaf extras -- the only tree facts not derivable from
    final-level occupancy (their sole point is always promoted away, but
    the node is real and meta records it with 0 points, as the reference's
    subsample does, generation.rs:195-253).  extras_total > extras_cap
    means the caller falls back to the classic (idx, final, leaf) arrays.

    Pad rows [n_real:] stay at the tail, unsorted: an int64 sentinel cannot
    sort last (a real code may be 2^63 - 1), so rows >= n_real are never
    sorted or read, and count into the last level_counts bin."""
    _check_codes(codes)
    n = codes.shape[0]
    dev = codes.device
    n_real = int(n_real)
    if not 0 <= n_real <= n:
        raise ValueError(f"n_real = {n_real} outside [0, {n}]")
    if n == 0:
        e32 = torch.zeros(0, dtype=torch.int32, device=dev)
        e8 = torch.zeros(0, dtype=torch.uint8, device=dev)
        return GroupedExchange(
            e32, torch.zeros(max_split_level + 2, dtype=torch.int32, device=dev),
            torch.zeros(extras_cap, dtype=torch.int32, device=dev),
            torch.zeros(extras_cap, dtype=torch.uint8, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev), e32, e8, e8,
        )
    vals, perm = torch.sort(codes[:n_real], stable=True)
    sorted_codes = torch.cat([vals, codes[n_real:]])
    idx = torch.cat([perm, torch.arange(n_real, n, device=dev)]).to(torch.int32)
    leaf, cur = _assign_and_promote(sorted_codes, depth, max_split_level,
                                    max_points_per_node, root_level,
                                    stop_level, n_real=n_real)

    # Pad rows sort after every real row whatever their own promotion.
    key = cur.clone()
    key[n_real:].fill_(max_split_level + 1)
    # A stable sort on key equals the JAX sort by (key, pos) (:622-625).
    sorted_key, by_key = torch.sort(key, stable=True)
    order2 = idx[by_key]
    # Per-level counts from the run bounds of the sorted key (the JAX
    # segment_sum, :627): no atomics, and no host read of the key's maximum
    # as torch.bincount makes on CUDA.
    bounds = torch.searchsorted(
        sorted_key.to(torch.int32),
        torch.arange(max_split_level + 3, dtype=torch.int32, device=dev))
    level_counts = torch.diff(bounds).to(torch.int32)

    # --- 1-point-leaf extras over the code-sorted order (:631-656) -------
    # Adjacent points share a leaf iff same leaf level AND same code prefix
    # at that level (shift 3 * (depth - leaf) <= 63).
    shift = 3 * (depth - leaf[1:].to(torch.int64))
    same = (leaf[1:] == leaf[:-1]) & (
        (sorted_codes[1:] >> shift) == (sorted_codes[:-1] >> shift))
    run_start = torch.cat([same.new_ones(1), ~same])
    if n_real < n:
        run_start[n_real:n_real + 1].fill_(True)  # the pad run is its own
    next_start = torch.cat([run_start[1:], run_start.new_ones(1)])
    sole = run_start & next_start
    sole[n_real:].fill_(False)

    # _scan (tree_build.py:97-124): on CUDA always the K1 kernel, one
    # look-back sweep.
    rank = scan_1d(sole.to(torch.int32), "sum") - 1
    extras_total = rank[-1] + 1
    slot = torch.where(sole & (rank < extras_cap), rank, extras_cap).long()
    # Each kept rank owns one slot; every other row lands in the spill slot
    # extras_cap, which is cut off.
    extras_idx = torch.zeros(extras_cap + 1, dtype=torch.int32, device=dev)
    extras_idx.scatter_(0, slot, idx)
    extras_level = torch.zeros(extras_cap + 1, dtype=torch.uint8, device=dev)
    extras_level.scatter_(0, slot, leaf)
    return GroupedExchange(order2, level_counts, extras_idx[:extras_cap],
                           extras_level[:extras_cap], extras_total, idx, cur,
                           leaf)


def upload_codes(codes_u64, device: torch.device) -> torch.Tensor:
    """Host uint64 Morton codes (< 2^63) -> int64 tensor on `device`.

    On CUDA the codes go through a pinned staging buffer and a
    non-blocking copy on the current stream: a pageable `.to("cuda")`
    would hold the host until the copy ends.  The caching host allocator
    keeps the staging block until that copy has run."""
    if device.type != "cuda":
        return morton.codes_to_tensor(codes_u64, device)
    codes = morton.check_codes(codes_u64)
    staging = torch.empty(len(codes), dtype=torch.int64, pin_memory=True)
    staging.numpy()[:] = codes.view(np.int64)
    return staging.to(device, non_blocking=True)


def tree_codes_grouped_on_device(
    codes_u64,            # (N,) host uint64 Morton codes (unsorted, < 2^63)
    depth: int,
    max_split_level: int,
    *,
    root_level: int = 0,
    stop_level: int = 0,
    device,
    extras_cap: Optional[int] = None,
    max_points_per_node: int = MAX_POINTS_PER_NODE,
) -> GroupedExchange:
    """Upload host codes and launch the grouped derivation on `device`'s
    current stream; returns at once, without waiting for the card.

    The port of tree_codes_grouped_on_device_padded (tree_build.py:663-
    686) without the padding: the JAX size ladder only bounds XLA's
    compiles, and PyTorch compiles nothing per shape.  Nothing between the
    upload and the caller's fetch reads the card from the host.
    `extras_cap` defaults to max(512, n >> 6), as the in-core build."""
    n = len(codes_u64)
    if extras_cap is None:
        extras_cap = max(512, n >> 6)
    return build_tree_device_codes_grouped(
        upload_codes(codes_u64, torch.device(device)), n, depth,
        max_split_level, max_points_per_node=max_points_per_node,
        root_level=root_level, stop_level=stop_level, extras_cap=extras_cap,
    )


class HostExchange(NamedTuple):
    """The grouped exchange as fetched: the fast arrays, or on extras
    overflow the classic code-sorted ones (the others are None)."""

    overflow: bool
    order2: Optional[np.ndarray]        # int64
    level_counts: Optional[np.ndarray]  # int32
    extras_idx: Optional[np.ndarray]    # int64, extras_total entries
    extras_level: Optional[np.ndarray]  # uint8
    idx: Optional[np.ndarray]           # int64
    final: Optional[np.ndarray]         # uint8
    leaf: Optional[np.ndarray]          # uint8
    nbytes: int                         # bytes moved to the host


def fetch_grouped(out: GroupedExchange) -> HostExchange:
    """Bring a finished grouped exchange to the host (builder.py:220-231,
    streaming.py:700-724): extras_total first, so only one of the two
    exchanges is moved.  On CUDA the arrays are copied on the current
    stream into pinned buffers, then that stream is waited on; the caller
    has made sure the derivation is done (same stream, or an event)."""
    dev = out.order2.device
    extras_total = int(out.extras_total)
    overflow = extras_total > out.extras_idx.shape[0]
    if overflow:
        tensors = (out.idx, out.final, out.leaf)
    else:
        tensors = (out.order2, out.level_counts,
                   out.extras_idx[:extras_total],
                   out.extras_level[:extras_total])
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        host = []
        for t in tensors:
            t.record_stream(stream)  # made on the derivation's stream
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host.append(h)
        stream.synchronize()
    else:
        host = tensors
    arrays = [h.numpy() for h in host]
    nbytes = 4 + sum(a.nbytes for a in arrays)
    if overflow:
        idx, final, leaf = arrays
        return HostExchange(True, None, None, None, None,
                            idx.astype(np.int64), final, leaf, nbytes)
    order2, counts, e_idx, e_level = arrays
    return HostExchange(False, order2.astype(np.int64), counts,
                        e_idx.astype(np.int64), e_level, None, None, None,
                        nbytes)
