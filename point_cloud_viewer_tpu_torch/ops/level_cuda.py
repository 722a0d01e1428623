"""K2-K4: the fused per-level sweeps of the tree derivation.

Port of point_cloud_viewer_tpu/ops/level_pallas.py.  Each level of the
leaf and promotion loops is one or two sweeps over the u8 boundary-level
array `b` (b[i] <= level <=> a segment starts at i).  On the card the
build runs K4 once a level (ops/tree_build.py); its leaf loop of K2 + K3
(ops/leaf_levels_cuda.leaf_stage_loop) is the CPU route and, on the card,
the yardstick of the K6 leaf stage that replaced it:

* seg_start_pass   (K2, fwd): b -> seg_start i32, the latest start <= i.
* leaf_update_pass (K3, rev): seg_end = first start > i (else n);
  where count = seg_end - seg_start <= threshold and no shallower level was
  small, leaf = level and found = 1.  leaf/found are updated IN PLACE.
* promote_pass     (K4, fwd): rank of the points with cur == level within
  their segment; every 8th moves to level - 1.  cur is updated IN PLACE.

Unlike the JAX kernels, which return new arrays, these update their u8
state in place (no second copy of the state per level), and they take
unpadded arrays: the CUDA kernels mask the ragged tail themselves.

Bounds (device-memory bytes an element): K2 5 (u8 b in, i32 out); K3 9;
K4 3.  K2 is one launch (after a memset of its scratch), the decoupled
look-back scan of csrc/lookback_scan.cuh: b is read once, 16 bytes a lane,
and seg_start written once, staged through shared memory to go out as 16 B
a lane; a tile holding a segment start publishes its prefix at once, so
look-backs stop there.  K3 and K4 are three launches of the reduce-then-
scan skeleton (csrc/scan_skeleton.cuh), which reads the input twice.

On a CUDA tensor each wrapper launches its kernel from csrc/level.cu and
counts it in `<wrapper>.launches`; on a CPU tensor it runs the plain
PyTorch version beside it, the looped formulation of
point_cloud_viewer_tpu/ops/tree_build.py:274-315.
"""

from __future__ import annotations

import torch

from . import _ext


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
        agg = _ext.scratch(n, 1, b.device)
        err = lib.pcv_leaf_update(
            b.data_ptr(), seg_start.data_ptr(), leaf.data_ptr(),
            found.data_ptr(), n, int(level), int(threshold), agg.data_ptr(),
            _ext.stream_ptr(b),
        )
    _ext.check(err, "leaf_update_pass")
    leaf_update_pass.launches += 1
    return leaf, found


def promote_pass(b: torch.Tensor, cur: torch.Tensor, level: int):
    """Forward sweep (K4): updates cur (u8) in place and returns it."""
    _check("promote_pass", b, (cur, torch.uint8))
    if not _ext.on_cuda("promote_pass", b, cur):
        return promote_pass_plain(b, cur, level)
    n = b.shape[0]
    if n == 0:
        return cur
    lib = _ext.lib()
    with torch.cuda.device(b.device):
        agg = _ext.scratch(n, 2, b.device)
        err = lib.pcv_promote(b.data_ptr(), cur.data_ptr(), n, int(level),
                              agg.data_ptr(), _ext.stream_ptr(b))
    _ext.check(err, "promote_pass")
    promote_pass.launches += 1
    return cur


seg_start_pass.launches = 0
leaf_update_pass.launches = 0
promote_pass.launches = 0
