"""K2-K4: the per-level sweeps of the tree derivation, and K4's stage.

Port of point_cloud_viewer_tpu/ops/level_pallas.py.  Each level of the
leaf and promotion loops is a sweep over the u8 boundary-level array `b`
(b[i] <= level <=> a segment starts at i).  On the card the build takes
its leaf levels from the K6 leaf stage and promotes with one
`promote_stage` launch (ops/tree_build.py); the per-level K2 + K3 loop
(ops/leaf_levels_cuda.leaf_stage_loop) and the K4 loop
(`promote_stage_loop`) are the CPU route's shape and, on the card, the
yardsticks of the stages that replaced them:

* seg_start_pass   (K2, fwd): b -> seg_start i32, the latest start <= i.
* leaf_update_pass (K3, rev): seg_end = first start > i (else n);
  where count = seg_end - seg_start <= threshold and no shallower level was
  small, leaf = level and found = 1.  leaf/found are updated IN PLACE.
* promote_pass     (K4, fwd): rank of the points with cur == level within
  their segment; every 8th moves to level - 1.  cur is updated IN PLACE.
* promote_stage    (K4, every level): leaf -> cur, promote_pass over levels
  max_split_level .. stop_level + 1, deepest first, in one launch.

Unlike the JAX kernels, which return new arrays, these update their u8
state in place (no second copy of the state per level), and they take
unpadded arrays: the CUDA kernels mask the ragged tail themselves.

Bounds (device-memory bytes an element): K2 5 (u8 b in, i32 out); K3 9;
K4 3, for one level or for all of them.  K2 is one launch (after a memset
of its scratch), the decoupled look-back scan of csrc/lookback_scan.cuh: b
is read once, 16 bytes a lane, and seg_start written once, staged through
shared memory to go out as 16 B a lane; a tile holding a segment start
publishes its prefix at once, so look-backs stop there.  K3 is three
launches of the reduce-then-scan skeleton (csrc/scan_skeleton.cuh), which
reads the input twice.  K4 (csrc/promote.cu) is one launch after one
memset, for one level or for all: each tile reads b and the levels once,
keeps them in registers across the levels, looks back over its
predecessors' 4-bit (segment started, count mod 8) states only where an
active row precedes its first start, and writes the levels once.

On a CUDA tensor each wrapper launches its kernel from csrc/level.cu or
csrc/promote.cu and counts it in `<wrapper>.launches`; on a CPU tensor it
runs the plain PyTorch version beside it, the looped formulation of
point_cloud_viewer_tpu/ops/tree_build.py:274-315.
"""

from __future__ import annotations

import torch

from . import _ext

# Levels K4 takes (csrc/promote.cu kPromoteMaxLevel): a lane keeps the set
# of levels its rows hold as 64 bits.
MAX_LEVEL = 63


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


# --- plain PyTorch versions ---------------------------------------------


def seg_start_pass_plain(b: torch.Tensor, level: int) -> torch.Tensor:
    iota = _iota(b.shape[0], b.device)
    return torch.cummax(torch.where(b <= level, iota, 0), 0).values


def leaf_update_pass_plain(b, seg_start, leaf, found, level: int,
                           threshold: int):
    n = b.shape[0]
    iota = _iota(n, b.device)
    nb = torch.where(b <= level, iota, n)
    nxt = torch.cummin(nb.flip(0), 0).values.flip(0)
    seg_end = torch.cat([nxt[1:], nxt.new_full((1,), n)])
    small = (seg_end - seg_start) <= threshold
    leaf.masked_fill_(small & (found == 0), level)
    found.logical_or_(small)
    return leaf, found


def promote_pass_plain(b, cur, level: int):
    active = (cur == level).to(torch.int32)
    c = torch.cumsum(active, 0, dtype=torch.int32)
    base = torch.cummax(torch.where(b <= level, c - active, 0), 0).values
    rank = c - active - base
    cur.masked_fill_((active == 1) & (rank % 8 == 0), level - 1)
    return cur


def _promote_loop(b, leaf, max_split_level: int, stop_level: int, step):
    cur = leaf.clone()
    for level in range(max_split_level, stop_level, -1):
        step(b, cur, level)
    return cur


def promote_stage_plain(b, leaf, max_split_level: int, stop_level: int):
    """`promote_stage`'s plain version: leaf.clone(), then the plain K4 at
    every level from max_split_level down to stop_level + 1."""
    return _promote_loop(b, leaf, max_split_level, stop_level,
                         promote_pass_plain)


# --- wrappers -----------------------------------------------------------


def _check(name: str, b: torch.Tensor, *state) -> None:
    """b: contiguous 1-D u8; state: (tensor, dtype) pairs shaped like b."""
    _ext.check_1d(name, b, torch.uint8)
    for t, dtype in state:
        _ext.check_1d(name, t, dtype)
        if t.shape != b.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(b.shape)}")


def seg_start_pass(b: torch.Tensor, level: int) -> torch.Tensor:
    """b (N,) u8 -> seg_start (N,) int32 (K2), one sweep counted in
    `seg_start_pass.launches`."""
    _check("seg_start_pass", b)
    if not _ext.on_cuda("seg_start_pass", b):
        return seg_start_pass_plain(b, level)
    n = b.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=b.device)
    if n == 0:
        return out
    lib = _ext.lib()
    with torch.cuda.device(b.device):
        scratch = _ext.lookback_scratch(n, b.device)
        err = lib.pcv_seg_start(b.data_ptr(), out.data_ptr(), n, int(level),
                                scratch.data_ptr(), _ext.stream_ptr(b))
    _ext.check(err, "seg_start_pass")
    seg_start_pass.launches += 1
    return out


def leaf_update_pass(b, seg_start, leaf, found, level: int, threshold: int):
    """Reverse sweep (K3): updates leaf and found (u8) in place and returns
    them."""
    _check("leaf_update_pass", b, (seg_start, torch.int32),
           (leaf, torch.uint8), (found, torch.uint8))
    if not _ext.on_cuda("leaf_update_pass", b, seg_start, leaf, found):
        return leaf_update_pass_plain(b, seg_start, leaf, found, level,
                                      threshold)
    n = b.shape[0]
    if n == 0:
        return leaf, found
    lib = _ext.lib()
    with torch.cuda.device(b.device):
        agg = _ext.scratch(n, b.device)
        err = lib.pcv_leaf_update(
            b.data_ptr(), seg_start.data_ptr(), leaf.data_ptr(),
            found.data_ptr(), n, int(level), int(threshold), agg.data_ptr(),
            _ext.stream_ptr(b),
        )
    _ext.check(err, "leaf_update_pass")
    leaf_update_pass.launches += 1
    return leaf, found


def _check_levels(name: str, stop_level: int, max_split_level: int) -> None:
    if not 0 <= stop_level <= max_split_level <= MAX_LEVEL:
        raise ValueError(f"{name}: need 0 <= stop_level {stop_level} <= "
                         f"max_split_level {max_split_level} <= {MAX_LEVEL}")


def _promote(name: str, b, cur_in, cur_out, hi: int, levels: int) -> None:
    """One run of csrc/promote.cu on b's stream: levels hi .. hi - levels
    + 1 of cur_in into cur_out (the same tensor for the in-place K4)."""
    n = b.shape[0]
    lib = _ext.lib()
    with torch.cuda.device(b.device):
        tiles = -(-n // lib.pcv_promote_tile_rows())
        # A tile counter and one state a tile a level; cleared by the C
        # entry on the launch's stream.
        scratch = torch.empty(1 + levels * tiles, dtype=torch.int64,
                              device=b.device)
        err = lib.pcv_promote(b.data_ptr(), cur_in.data_ptr(),
                              cur_out.data_ptr(), n, int(hi), int(levels),
                              scratch.data_ptr(), _ext.stream_ptr(b))
    _ext.check(err, name)


def promote_pass(b: torch.Tensor, cur: torch.Tensor, level: int):
    """Forward sweep (K4) at one level: updates cur (u8) in place and
    returns it."""
    _check("promote_pass", b, (cur, torch.uint8))
    if not 1 <= level <= MAX_LEVEL:
        raise ValueError(f"promote_pass: level {level} outside [1, "
                         f"{MAX_LEVEL}]")
    if not _ext.on_cuda("promote_pass", b, cur):
        return promote_pass_plain(b, cur, level)
    if b.shape[0] == 0:
        return cur
    _promote("promote_pass", b, cur, cur, level, 1)
    promote_pass.launches += 1
    return cur


def promote_stage_loop(b, leaf, max_split_level: int, stop_level: int):
    """The promotion as a loop of `promote_pass`: on the card one K4
    launch a level, the yardstick that `promote_stage` replaced; on CPU
    tensors `promote_stage_plain`."""
    _check_levels("promote_stage_loop", stop_level, max_split_level)
    return _promote_loop(b, leaf, max_split_level, stop_level, promote_pass)


def promote_stage(b: torch.Tensor, leaf: torch.Tensor, max_split_level: int,
                  stop_level: int) -> torch.Tensor:
    """b, leaf (N,) u8 -> cur (N,) u8: leaf promoted at every level from
    max_split_level down to stop_level + 1 (K4 over all levels, one launch
    counted in `promote_stage.launches`).  Every level is swept, empty ones
    included, so the host never asks the card which levels hold points."""
    _check("promote_stage", b, (leaf, torch.uint8))
    _check_levels("promote_stage", stop_level, max_split_level)
    if not _ext.on_cuda("promote_stage", b, leaf):
        return promote_stage_plain(b, leaf, max_split_level, stop_level)
    cur = torch.empty(b.shape[0], dtype=torch.uint8, device=b.device)
    if b.shape[0] == 0:
        return cur
    _promote("promote_stage", b, leaf, cur, max_split_level,
             max_split_level - stop_level)
    promote_stage.launches += 1
    return cur


seg_start_pass.launches = 0
leaf_update_pass.launches = 0
promote_pass.launches = 0
promote_stage.launches = 0
