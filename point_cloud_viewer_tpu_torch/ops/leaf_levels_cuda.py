"""K6: the leaf stage of the tree derivation, sorted codes -> boundary and
leaf levels, in one hand-written pass (csrc/leaf_levels.cu).

Two entries launch the same kernel:

* `leaf_stage` -- the device core's leaf stage (ops/tree_build.py
  `_assign_and_promote`): sorted int64 codes -> (b, leaf), both u8 in
  code-sorted order.  b is `_bound_levels` (the boundary level; K4 still
  reads it) and leaf what the per-level K2 + K3 loop `leaf_stage_loop`
  gives: the first level in root_level+1..max_split_level whose segment
  holds <= max_points points, with `b <= level` as the start rule at every
  level and the pad-row rule of `_bound_levels(n_real=)`.  It replaces that
  loop and the plain `_bound_levels` on the build path.
* `leaf_levels` -- the port of point_cloud_viewer_tpu/ops/tree_build_pallas.py
  `leaf_levels_pallas`: int32 leaf levels over 1..max_split_level, where
  past `depth` only row 0 starts a segment, as in the Pallas kernel.  The
  two rules differ only when max_split_level > depth.

On a CUDA tensor each entry launches the kernel and counts it in its own
`<entry>.launches`; on a CPU tensor it runs its plain version:
`leaf_stage_plain` (the plain `_bound_levels`, then the plain K2 + K3
loop, what the build ran on the CPU before) and `leaf_levels_plain`.  No
entry falls back from the card to a plain version.  `leaf_stage_loop` is
the same loop through the K2 and K3 wrappers: on the card, the stage the
kernel replaced, kept as its yardstick.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _ext
from .level_cuda import (
    leaf_update_pass,
    leaf_update_pass_plain,
    seg_start_pass,
    seg_start_pass_plain,
)

MAX_LEVELS = 21  # 63-bit codes


def _high_bit(x: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of each x in [1, 2^63) (0 for x == 0).

    torch has no clz; a float log2 rounds above 2^53 and would give the
    wrong bit, so this is a 6-step binary search on comparisons."""
    hsb = torch.zeros_like(x)
    v = x
    for s in (32, 16, 8, 4, 2, 1):
        m = v >= (1 << s)
        hsb += m.to(x.dtype) * s
        v = torch.where(m, v >> s, v)
    return hsb


def _bound_levels(codes: torch.Tensor, depth: int,
                  n_real: Optional[int] = None) -> torch.Tensor:
    """tree_build.py:163-178.  Per-point u8 boundary level over SORTED
    codes: the shallowest level whose prefix changes between codes i-1 and
    i.  Row 0 XORs with ~c[0]; the result is negative, so its high bit
    counts as 63 and its boundary level as 0 (a boundary at every level).
    Codes equal to their predecessor get depth+1 (never a boundary).

    Rows >= n_real are pad rows (the JAX package's 0xFFFFFFFF sentinels,
    whose int64 join is -1 and would sort first): their values are never
    read.  The first pad row gets boundary 0, the rest depth+1 -- what the
    JAX sentinel run yields (tree_build.py:476-489)."""
    n = codes.shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.uint8, device=codes.device)
    x = codes ^ torch.cat([~codes[:1], codes[:-1]])
    hsb = torch.where(x < 0, 63, _high_bit(x.clamp_min(0)))
    b = torch.where(
        x == 0, depth + 1, (depth - torch.div(hsb, 3, rounding_mode="floor"))
        .clamp_min(0),
    ).to(torch.uint8)
    if n_real is not None and n_real < n:
        # fill_ on views: a scalar assignment would copy a host scalar up
        # and synchronise.
        b[n_real:n_real + 1].fill_(0)
        b[n_real + 1:].fill_(depth + 1)
    return b


def _check(name: str, sorted_codes: torch.Tensor, depth: int,
           max_split_level: int, root_level: int = 0):
    _ext.check_1d(name, sorted_codes, torch.int64)
    if not 0 <= root_level < max_split_level <= MAX_LEVELS:
        raise ValueError(f"{name}: need 0 <= root_level {root_level} < "
                         f"max_split_level {max_split_level} <= {MAX_LEVELS}")
    if not 0 <= depth <= MAX_LEVELS:
        raise ValueError(f"{name}: depth {depth} outside [0, {MAX_LEVELS}]")


def _threshold(max_points: int) -> int:
    """max_points clamped to int32: a count is in [1, n] with n < 2^31, so
    the clamp keeps every comparison."""
    return max(-1, min(int(max_points), 2**31 - 1))


def _launch(name: str, sorted_codes: torch.Tensor, leaf_dtype, depth: int,
            root_level: int, max_split_level: int, max_points: int,
            n_real: int, k6_rule: bool):
    """One run of csrc/leaf_levels.cu on sorted_codes' stream -> (b u8,
    leaf of leaf_dtype); n > 0."""
    n = sorted_codes.shape[0]
    dev = sorted_codes.device
    b = torch.empty(n, dtype=torch.uint8, device=dev)
    leaf = torch.empty(n, dtype=leaf_dtype, device=dev)
    levels = max_split_level - root_level
    lib = _ext.lib()
    with _ext.device_guard(sorted_codes):
        tiles = -(-n // lib.pcv_leaf_tile_rows())
        scratch = torch.empty(2 * levels * tiles, dtype=torch.int32,
                              device=dev)
        err = lib.pcv_leaf_stage(
            sorted_codes.data_ptr(), b.data_ptr(), leaf.data_ptr(),
            int(leaf_dtype == torch.int32), n, int(n_real), int(depth),
            root_level + 1, levels, int(k6_rule), _threshold(max_points),
            scratch.data_ptr(), _ext.stream_ptr(sorted_codes),
        )
    _ext.check(err, name)
    return b, leaf


# --- the device core's leaf stage ------------------------------------------


def _looped(sorted_codes, depth, max_split_level, max_points, root_level,
            n_real, seg_start, leaf_update):
    """`_bound_levels`, then per leaf level one segment-start and one
    leaf-update sweep (tree_build.py:274-315) -> (b, leaf) u8."""
    b = _bound_levels(sorted_codes, depth, n_real)
    n = b.shape[0]
    leaf = torch.full((n,), max_split_level, dtype=torch.uint8,
                      device=b.device)
    found = torch.zeros(n, dtype=torch.uint8, device=b.device)
    # Clamped: compared with an int32 count, 2^40 would wrap to 0.
    threshold = _threshold(max_points)
    for level in range(root_level + 1, max_split_level + 1):
        leaf_update(b, seg_start(b, level), leaf, found, level, threshold)
    return b, leaf


def leaf_stage_plain(sorted_codes: torch.Tensor, depth: int,
                     max_split_level: int, max_points: int,
                     root_level: int = 0, n_real: Optional[int] = None):
    """`leaf_stage`'s plain PyTorch version: the looped formulation on the
    plain K2 and K3 sweeps, on whatever device the codes lie."""
    return _looped(sorted_codes, depth, max_split_level, max_points,
                   root_level, n_real, seg_start_pass_plain,
                   leaf_update_pass_plain)


def leaf_stage_loop(sorted_codes: torch.Tensor, depth: int,
                    max_split_level: int, max_points: int,
                    root_level: int = 0, n_real: Optional[int] = None):
    """The looped formulation through the K2 and K3 wrappers
    (ops/level_cuda): on the card their kernels run, 2 x levels sweeps, the
    yardstick that `leaf_stage` replaced; on CPU tensors it is
    `leaf_stage_plain`."""
    return _looped(sorted_codes, depth, max_split_level, max_points,
                   root_level, n_real, seg_start_pass, leaf_update_pass)


def leaf_stage(sorted_codes: torch.Tensor, depth: int, max_split_level: int,
               max_points: int, root_level: int = 0,
               n_real: Optional[int] = None):
    """Sorted (N,) int64 codes -> (b, leaf), both (N,) u8 in code-sorted
    order: what `leaf_stage_loop` gives, in one run of K6 on the card."""
    _check("leaf_stage", sorted_codes, depth, max_split_level, root_level)
    n = sorted_codes.shape[0]
    if n_real is None:
        n_real = n
    if not 0 <= n_real <= n:
        raise ValueError(f"leaf_stage: n_real = {n_real} outside [0, {n}]")
    if not _ext.on_cuda("leaf_stage", sorted_codes):
        return leaf_stage_plain(sorted_codes, depth, max_split_level,
                                max_points, root_level, n_real)
    if n == 0:
        empty = torch.empty(0, dtype=torch.uint8, device=sorted_codes.device)
        return empty, empty.clone()
    out = _launch("leaf_stage", sorted_codes, torch.uint8, depth, root_level,
                  max_split_level, max_points, n_real, k6_rule=False)
    leaf_stage.launches += 1
    return out


# --- the public K6 ------------------------------------------------------


def leaf_levels_plain(sorted_codes: torch.Tensor, depth: int,
                      max_split_level: int, max_points: int) -> torch.Tensor:
    """The plain PyTorch version: per level, a cummax of segment starts and
    a reversed cummin of the next start, as the lax twin in
    tests/test_tree_build_pallas.py builds them."""
    _check("leaf_levels", sorted_codes, depth, max_split_level)
    b = _bound_levels(sorted_codes, depth)
    n = b.shape[0]
    dev = b.device
    leaf = torch.full((n,), max_split_level, dtype=torch.int32, device=dev)
    if n == 0:
        return leaf
    threshold = _threshold(max_points)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    for level in range(1, max_split_level + 1):
        starts = (b <= level) if level <= depth else (iota == 0)
        seg_start = torch.cummax(torch.where(starts, iota, 0), 0).values
        nb = torch.where(starts, iota, n)
        nxt = torch.cummin(nb.flip(0), 0).values.flip(0)
        seg_end = torch.cat([nxt[1:], nxt.new_full((1,), n)])
        small = (seg_end - seg_start) <= threshold
        leaf.masked_fill_(small & ~found, level)
        found |= small
    return leaf


def leaf_levels(sorted_codes: torch.Tensor, depth: int, max_split_level: int,
                max_points: int) -> torch.Tensor:
    """sorted_codes (N,) int64 -> leaf level (N,) int32 (K6)."""
    _check("leaf_levels", sorted_codes, depth, max_split_level)
    if not _ext.on_cuda("leaf_levels", sorted_codes):
        return leaf_levels_plain(sorted_codes, depth, max_split_level,
                                 max_points)
    n = sorted_codes.shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=sorted_codes.device)
    _, out = _launch("leaf_levels", sorted_codes, torch.int32, depth, 0,
                     max_split_level, max_points, n, k6_rule=True)
    leaf_levels.launches += 1
    return out


leaf_stage.launches = 0
leaf_levels.launches = 0
