"""K6: the leaf level of every point over all levels in one kernel.

Port of point_cloud_viewer_tpu/ops/tree_build_pallas.py
(`leaf_levels_pallas`).  Over SORTED codes, each point's leaf level is the
first level l in 1..max_split_level whose segment (the run of codes that
share the level-l prefix) holds <= max_points points, else max_split_level.
Row 0 starts a segment at every level, and at levels past `depth` no other
row does, as in the Pallas kernel.

Like the JAX function, K6 sits on no product path: the device core keeps
its per-level K2 + K3 leaf stage (ops/tree_build.py), which gives the same
levels whenever depth >= max_split_level, as every build calls it.  Whether
K6 replaces that stage is for the card's numbers to decide (PERF.md).

On a CUDA tensor `leaf_levels` launches csrc/leaf_levels.cu and counts it
in `leaf_levels.launches`; on a CPU tensor it runs `leaf_levels_plain`.
"""

from __future__ import annotations

import torch

from . import _ext
from .tree_build import _bound_levels

MAX_LEVELS = 21  # 63-bit codes


def _check(sorted_codes: torch.Tensor, depth: int, max_split_level: int):
    _ext.check_1d("leaf_levels", sorted_codes, torch.int64)
    if not 1 <= max_split_level <= MAX_LEVELS:
        raise ValueError(f"leaf_levels: max_split_level {max_split_level} "
                         f"outside [1, {MAX_LEVELS}]")
    if not 0 <= depth <= MAX_LEVELS:
        raise ValueError(f"leaf_levels: depth {depth} outside "
                         f"[0, {MAX_LEVELS}]")


def _threshold(max_points: int) -> int:
    """max_points clamped to int32: a count is in [1, n] with n < 2^31, so
    the clamp keeps every comparison."""
    return max(-1, min(int(max_points), 2**31 - 1))


def leaf_levels_plain(sorted_codes: torch.Tensor, depth: int,
                      max_split_level: int, max_points: int) -> torch.Tensor:
    """The plain PyTorch version: per level, a cummax of segment starts and
    a reversed cummin of the next start, as the lax twin in
    tests/test_tree_build_pallas.py builds them."""
    _check(sorted_codes, depth, max_split_level)
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
    _check(sorted_codes, depth, max_split_level)
    if not _ext.on_cuda("leaf_levels", sorted_codes):
        return leaf_levels_plain(sorted_codes, depth, max_split_level,
                                 max_points)
    n = sorted_codes.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=sorted_codes.device)
    if n == 0:
        return out
    b = _bound_levels(sorted_codes, depth)
    threshold = _threshold(max_points)
    lib = _ext.lib()
    with torch.cuda.device(b.device):
        scratch = _ext.scratch(n, 2 * max_split_level, b.device)
        err = lib.pcv_leaf_levels(
            b.data_ptr(), out.data_ptr(), n, int(depth),
            int(max_split_level), threshold, scratch.data_ptr(),
            _ext.stream_ptr(b),
        )
    _ext.check(err, "leaf_levels")
    leaf_levels.launches += 1
    return out


leaf_levels.launches = 0
