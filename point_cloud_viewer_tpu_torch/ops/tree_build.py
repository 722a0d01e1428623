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
from ..device import resolve_device
from . import morton
# _bound_levels lives beside the kernel that replaced it on the card; it is
# re-exported here, where the JAX package has it.
from .leaf_levels_cuda import _bound_levels, leaf_stage  # noqa: F401
from .level_cuda import promote_stage
from .scan_cuda import scan_1d

# Segment positions and permutations are int32, as in the JAX package.
_MAX_N = 2**31 - 1
# Flips bit 63 of an int64 key: signed order then is unsigned order.
_SIGN_BIT = -(1 << 63)


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


def _sort_real(codes: torch.Tensor, n_real: Optional[int]):
    """A stable sort of rows [0, n_real) (default: every row) -> (sorted
    codes, int32 permutation).  Pad rows [n_real:] stay at the tail,
    unsorted and mapping to themselves: an int64 sentinel cannot sort last
    (a real code may be 2^63 - 1), so they are never sorted or read."""
    n = codes.shape[0]
    n_real = n if n_real is None else int(n_real)
    if not 0 <= n_real <= n:
        raise ValueError(f"n_real = {n_real} outside [0, {n}]")
    vals, perm = torch.sort(codes[:n_real], stable=True)
    if n_real == n:
        return vals, perm.to(torch.int32)
    return (torch.cat([vals, codes[n_real:]]),
            torch.cat([perm, torch.arange(n_real, n, device=codes.device)]
                      ).to(torch.int32))


def build_tree_device_codes(
    codes: torch.Tensor,  # (N,) int64 Morton codes (unsorted, < 2^63)
    depth: int,
    max_split_level: int,
    max_points_per_node: int = MAX_POINTS_PER_NODE,
    root_level: int = 0,
    stop_level: int = 0,
    n_real: Optional[int] = None,  # rows [n_real:] are pad rows
):
    """tree_build.py:439-465: -> (order int32 sorted -> original index,
    final u8, leaf u8), all in code-sorted order.  Pad rows [n_real:]
    (default: none) stay at the tail, as in build_tree_device_codes_grouped,
    and take the leaf and final levels of the JAX package's sentinel rows
    (K6's pad-row rule)."""
    _check_codes(codes)
    sorted_codes, idx = _sort_real(codes, n_real)
    leaf, cur = _assign_and_promote(sorted_codes, depth, max_split_level,
                                    max_points_per_node, root_level,
                                    stop_level, n_real=n_real)
    return idx, cur, leaf


class DeviceTreeResult(NamedTuple):
    """build_tree_device's outputs (tree_build.py:36-42), in code-sorted
    order; one int64 code in place of the JAX (hi, lo) pair."""

    codes: torch.Tensor        # (N,) int64 sorted Morton codes
    order: torch.Tensor        # (N,) int64 sorted -> original index
    final_level: torch.Tensor  # (N,) u8 level each point ends up in
    leaf_level: torch.Tensor   # (N,) u8 pre-promotion leaf level
    t_norm: torch.Tensor       # (N, 3) f32 node-normalized coordinates


def build_tree_device(
    cells: torch.Tensor,  # (N, 3) integer grid cells at `depth`
    depth: int,
    max_split_level: int,
    max_points_per_node: int = MAX_POINTS_PER_NODE,
) -> DeviceTreeResult:
    """The full build core on the cells' device (tree_build.py:718-752):
    Morton encode, a stable sort of the codes, a gather of the cells, the
    leaf and promotion stages (K6 and K4 on the card), and each point's
    coordinates normalized to its final node.

    t_norm = (local + 0.5) / 2^s with s = depth - final level and local the
    cell's low s bits: local < 2^21 and the divisor an exact power of two,
    so the f32 result is exact.  (The JAX package divides by `jnp.exp2(s)`,
    which XLA:CPU rounds for odd s >= 13; there the two differ by a few
    ulp.)"""
    codes = morton.morton_encode_device(cells, depth)
    _check_codes(codes)
    codes, order = torch.sort(codes, stable=True)
    sorted_cells = cells[order].to(torch.int64)
    leaf, cur = _assign_and_promote(codes, depth, max_split_level,
                                    max_points_per_node)
    s = (depth - cur.to(torch.int64)).unsqueeze(1)
    local = sorted_cells - ((sorted_cells >> s) << s)
    t_norm = (local.to(torch.float32) + 0.5) / (1 << s).to(torch.float32)
    return DeviceTreeResult(codes, order, cur, leaf, t_norm)


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
    sorted_codes, idx = _sort_real(codes, n_real)
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


def upload_codes(codes_u64, device: torch.device,
                 n_real: Optional[int] = None) -> torch.Tensor:
    """Host uint64 Morton codes (< 2^63) -> int64 tensor on `device`.

    Rows [n_real:] (default: none) are pad rows: their bits are uploaded
    as they are, unchecked (the JAX sentinels become -1).  On CUDA the
    codes go through a pinned staging buffer and a non-blocking copy on
    the current stream: a pageable `.to("cuda")` would hold the host until
    the copy ends.  The caching host allocator keeps the staging block
    until that copy has run."""
    codes = np.ascontiguousarray(codes_u64, dtype=np.uint64)
    morton.check_codes(codes[:n_real])
    if device.type != "cuda":
        return torch.from_numpy(codes.view(np.int64)).to(device)
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


# --- the padded entries (tree_build.py:468-556, 663-698) -----------------
#
# The JAX package pads variable-size device calls with a size ladder so
# that XLA compiles one program a size bucket; PyTorch compiles nothing a
# shape, so the port's own callers take the unpadded entries above.  These
# keep the JAX entries' contract for callers that hold JAX's u32 code
# halves: the same ladder (copied below, unchanged), outputs of the padded
# length.  The sentinel rows cannot be int64 codes that sort last (a real
# code may be 2^63 - 1), so the device tensor holds the real rows and the
# pad rows joined to -1, and the core is told n_real = n: it sorts and
# reads only the real rows, and K6's pad-row rule gives the pad rows the
# leaf levels that JAX's sentinels get.

# tree_build.py:489-533, unchanged.
_PAD_MIN = 1 << 16


def pad_codes_pow2(hi, lo):
    """Host numpy u32 code halves -> (padded hi, padded lo, real n).

    Padded sizes come from the {2^k, 3*2^(k-1)} bucket ladder (steps of
    1.33x/1.5x) rather than pure powers of two: pad bytes ride the full
    host->device upload (the measured binding phase of the streaming
    device path on relayed links), and the extra mid bucket cuts the
    average upload waste from ~1.39x to ~1.2x for at most 2x compile
    variety.  Sentinel fill is 0xFFFFFFFF in BOTH halves: real hi words
    carry only Morton bits 32..62 (bit 31 clear), so sentinels sort
    strictly after every real row and share no code prefix with one."""
    import numpy as np

    n = int(hi.shape[0])
    if n:
        p = 1 << (n - 1).bit_length()  # next pow2 >= n
        mid = 3 * (p >> 2)             # 1.5 * previous pow2
        n_pad = max(_PAD_MIN, mid if n <= mid else p)
    else:
        n_pad = 0
    if n_pad > n:
        fill = np.full(n_pad - n, 0xFFFFFFFF, dtype=np.uint32)
        hi = np.concatenate([hi, fill])
        lo = np.concatenate([lo, fill])
    return hi, lo, n


def pad_rows_pow2(arr, floor: int = 512):
    """Pad a host array's leading axis to the next power of two (>= floor)
    by repeating row 0 — the compile-bucketing policy for per-row device
    kernels (one compiled program per size bucket, not per distinct node
    point count).  Row 0's duplicates are inert for pure per-row kernels;
    the caller slices the result back to real_n.  Returns (padded, real_n)."""
    import numpy as np

    n = int(arr.shape[0])
    n_pad = max(floor, 1 << (n - 1).bit_length()) if n else 0
    if n_pad > n:
        pad = np.broadcast_to(arr[:1], (n_pad - n,) + arr.shape[1:])
        arr = np.concatenate([arr, pad])
    return arr, n


def _padded_codes(hi, lo, device) -> tuple:
    """JAX's host u32 code halves -> (int64 codes of pad_codes_pow2's
    padded length on `device`, launched without a host sync; the real n).
    `device=None` is the card, as JAX's None is its default device."""
    hi, lo, n = pad_codes_pow2(np.asarray(hi, dtype=np.uint32),
                               np.asarray(lo, dtype=np.uint32))
    dev = resolve_device("cuda" if device is None else device)
    return upload_codes(morton.join_u64(hi, lo), dev, n_real=n), n


def tree_codes_on_device_padded(
    hi, lo, depth, max_split_level,
    max_points_per_node: int = MAX_POINTS_PER_NODE,
    root_level: int = 0, stop_level: int = 0, device=None,
):
    """build_tree_device_codes over pad_codes_pow2-padded host codes
    (tree_build.py:536-556).

    Returns (idx int32, final u8, leaf u8) of the PADDED length on
    `device`, UNFORCED (the call returns without waiting for the card),
    plus the real n; the caller slices [:n].  Rows [0, n) equal the
    unpadded call's bit for bit; the pad rows hold what JAX's contract
    leaves to it (here: idx the pad rows' own indices, final and leaf the
    levels of JAX's sentinel run)."""
    codes, n = _padded_codes(hi, lo, device)
    idx, final, leaf = build_tree_device_codes(
        codes, depth, max_split_level, max_points_per_node, root_level,
        stop_level, n_real=n)
    return idx, final, leaf, n


def tree_codes_grouped_on_device_padded(
    hi, lo, depth, max_split_level,
    max_points_per_node: int = MAX_POINTS_PER_NODE,
    root_level: int = 0, stop_level: int = 0, device=None,
    extras_cap: int = None,
):
    """build_tree_device_codes_grouped over pad_codes_pow2-padded host
    codes (tree_build.py:663-686).

    Returns (GroupedExchange, real n); every tensor is UNFORCED and of the
    padded length (level_counts' last bin counts the pad rows).  The
    caller fetches order2[:n] etc. and touches the classic per-point
    arrays only on extras overflow.  extras_cap defaults to max(512,
    padded length >> 6), as at tree_build.py:682; tests set it to force
    the overflow."""
    codes, n = _padded_codes(hi, lo, device)
    if extras_cap is None:
        extras_cap = max(512, codes.shape[0] >> 6)
    out = build_tree_device_codes_grouped(
        codes, n, depth, max_split_level, max_points_per_node, root_level,
        stop_level, extras_cap)
    return out, n


def sort_codes_device(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Stable sort of split Morton codes on their tensors' device -> int32
    permutation (sorted -> original index), as tree_build.py:689-698.

    hi and lo hold the u32 halves (int64, or int32 bit patterns: each is
    masked to 32 bits).  The key is the joined code with bit 63 flipped,
    so the signed sort keeps unsigned order and JAX's 0xFFFFFFFF sentinel
    rows sort after every real row, as there; one stable torch.sort, as
    argsort_codes_on_device."""
    mask = 0xFFFFFFFF
    key = ((hi.to(torch.int64) & mask) << 32) | (lo.to(torch.int64) & mask)
    _, perm = torch.sort(key ^ _SIGN_BIT, stable=True)
    return perm.to(torch.int32)


def argsort_codes_on_device(codes_u64, device):
    """Host uint64 Morton codes (< 2^63) -> (sorted codes, int64 order),
    the sort on `device`: the deep build's top sort and the streamed deep
    bucket's (tree_build.py:689-715).

    A stable sort on the int64 key gives the order of JAX's 3-key sort over
    (hi, lo, idx), because idx is unique.  No padding: the JAX size ladder
    and its sentinel codes only bound XLA's compiles.  On CUDA the order
    comes back through a pinned buffer on the current stream."""
    dev = torch.device(device)
    _, perm = torch.sort(upload_codes(codes_u64, dev), stable=True)
    if dev.type == "cuda":
        host = torch.empty(perm.shape, dtype=perm.dtype, pin_memory=True)
        host.copy_(perm, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        perm = host
    order = perm.numpy()
    return codes_u64[order], order


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
