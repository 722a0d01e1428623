"""The reference octree build: what the upstream `build_octree` writes for a
set of points, worked out in plain PyTorch on any device.

The rules (the cartographer point_cloud_viewer's on-disk octree, meta.pb
version 13):
- the root cube has the points' bounding box's min corner and its longest
  side; the depth cap is the first level whose cell edge is at most the
  resolution, at most 21 (63-bit Morton codes);
- points are quantised to that level's grid, Morton-coded (x, y, z from
  the most significant bit) and stably sorted by code;
- top down, a node with more than `max_points` points splits (the root
  always splits, the cap never), and every other non-empty node is a leaf;
- bottom up, every node hands each 8th of its points (rank 0, 8, 16, ... in
  code order) to its parent and keeps the rest; a node left with none
  stays in the tree (meta.pb lists it with no points, and it has no files);
- each node's positions are stored relative to its cube (u8, u16, f32 or
  f64 by the cube's edge over the resolution), beside its colours and
  intensities, in files named after its path; meta.pb lists the nodes.

`dtype` is the precision the positions are computed in: float64 as the
configuration states, float32 for the control.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

MAX_CODE_LEVEL = 21
META_VERSION = 13
# Spread the low 21 bits of x to every third bit (int64 masks).
_SPREAD = ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
           (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
           (2, 0x1249249249249249))


@dataclass
class RefOctree:
    depth: int
    root_min: np.ndarray        # (3,) f64
    root_edge: float
    bbox: tuple                 # ((3,), (3,)) f64
    levels: np.ndarray          # (K,) node levels, sorted by (level, path)
    paths: np.ndarray           # (K,) int64
    counts: np.ndarray          # (K,) points a node
    node_min: np.ndarray        # (K, 3) f64
    node_edge: np.ndarray       # (K,)
    encodings: np.ndarray       # (K,) 1 u8, 2 u16, 3 f32, 4 f64
    point_order: torch.Tensor   # (N,) input index of each stored point,
                                # nodes back to back in node order
    offsets: np.ndarray         # (K + 1,) into point_order
    files: Dict[str, bytes]     # expected file name -> bytes


def node_name(level: int, path: int) -> str:
    return "r" + (format(path, "o").zfill(level) if level else "")


def _spread(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x1FFFFF
    for shift, mask in _SPREAD:
        x = (x | (x << shift)) & mask
    return x


def _encoding(edge: float, resolution: float) -> int:
    ratio = edge / resolution
    if ratio <= 0 or not np.isfinite(ratio):
        return 1
    bits = max(int(np.log2(ratio)), 0) + 1
    return 1 if bits <= 8 else 2 if bits <= 16 else 3 if bits <= 24 else 4


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _field(num: int, wire: int, payload: bytes) -> bytes:
    return _varint(num << 3 | wire) + payload


def _msg(num: int, body: bytes) -> bytes:
    return _field(num, 2, _varint(len(body)) + body)


def _double(num: int, v: float) -> bytes:
    return _field(num, 1, struct.pack("<d", v)) if v != 0.0 else b""


def _uint(num: int, v: int) -> bytes:
    return _field(num, 0, _varint(v)) if v else b""


def meta_bytes(tree: RefOctree, resolution: float) -> bytes:
    """meta.pb (proto3: zero scalars left out, fields in number order)."""
    vec = [b"".join(_double(i + 1, float(c)) for i, c in enumerate(v))
           for v in tree.bbox]
    nodes = []
    for level, path, count, enc in zip(tree.levels, tree.paths, tree.counts,
                                       tree.encodings):
        value = (int(level) << 120) | int(path)
        node_id = _uint(3, value >> 64) + _uint(4, value & ((1 << 64) - 1))
        nodes.append(_msg(3, _uint(2, int(enc)) + _uint(3, int(count))
                          + _msg(4, node_id)))
    octree = _double(2, resolution) + b"".join(nodes)
    return (_uint(1, META_VERSION) + _msg(4, _msg(3, vec[0]) + _msg(4, vec[1]))
            + _msg(6, octree))


def build(position: np.ndarray, color: np.ndarray, intensity: np.ndarray,
          resolution: float, max_points: int, device="cpu",
          dtype=torch.float64) -> RefOctree:
    dev = torch.device(device)
    p = torch.as_tensor(position, device=dev).to(dtype)
    lo, hi = p.min(0).values, p.max(0).values
    edge = (hi - lo).max()
    root_edge = float(edge)
    depth = 1
    while depth < MAX_CODE_LEVEL and root_edge / (1 << depth) > resolution:
        depth += 1
    if depth == MAX_CODE_LEVEL and root_edge / (1 << depth) > resolution:
        raise ValueError("the reference builds no tree deeper than 21 levels")
    scale = float(1 << depth)
    cells = torch.floor((p - lo) / edge * scale).clamp(0, scale - 1).long()
    codes = (_spread(cells[:, 0]) << 2) | (_spread(cells[:, 1]) << 1) \
        | _spread(cells[:, 2])
    del cells
    sorted_codes, order = torch.sort(codes, stable=True)
    del codes
    n = len(sorted_codes)

    # Top down: each point's leaf level.
    leaf = torch.full((n,), -1, dtype=torch.int64, device=dev)
    active = torch.arange(n, device=dev)
    for level in range(1, depth + 1):
        if len(active) == 0:
            break
        key = sorted_codes[active] >> (3 * (depth - level))
        _, inverse, counts = torch.unique_consecutive(
            key, return_inverse=True, return_counts=True)
        is_leaf = (counts[inverse] <= max_points) | (level == depth)
        leaf[active[is_leaf]] = level
        active = active[~is_leaf]

    # Bottom up: every 8th point of a node moves to its parent.
    cur = leaf.clone()
    for level in range(depth, 0, -1):
        sel = torch.nonzero(cur == level).flatten()
        if len(sel) == 0:
            continue
        key = sorted_codes[sel] >> (3 * (depth - level))
        starts = torch.ones(len(sel), dtype=torch.bool, device=dev)
        starts[1:] = key[1:] != key[:-1]
        idx = torch.arange(len(sel), device=dev)
        run_start = torch.cummax(torch.where(starts, idx, 0), 0).values
        promote = (idx - run_start) % 8 == 0
        cur[sel[promote]] = level - 1

    # Every node of the tree, in (level, path) order: each point's cells
    # from the root down to its leaf.  A node whose points all moved up
    # stays in the tree with none.
    node_levels, node_paths = [], []
    for level in range(0, depth + 1):
        sel = leaf >= level
        if level and not bool(sel.any()):
            break
        keys = torch.unique_consecutive(
            sorted_codes[sel] >> (3 * (depth - level)))
        node_levels.append(torch.full_like(keys, level))
        node_paths.append(keys)
    levels_t = torch.cat(node_levels)
    paths_t = torch.cat(node_paths)

    # Points in (level, path) order, in code order within a node.
    by_level = torch.sort(cur, stable=True).indices
    lvl = cur[by_level]
    key = sorted_codes[by_level] >> (3 * (depth - lvl))
    counts_t = torch.zeros(len(paths_t), dtype=torch.int64, device=dev)
    base = 0
    for level, paths_l in enumerate(node_paths):
        at = torch.searchsorted(paths_l, key[lvl == level])
        counts_t[base:base + len(paths_l)] = torch.bincount(
            at, minlength=len(paths_l))
        base += len(paths_l)
    counts = counts_t.cpu().numpy()
    levels = levels_t.cpu().numpy()
    paths = paths_t.cpu().numpy()
    offsets = np.concatenate([[0], np.cumsum(counts)])
    point_order = order[by_level]

    # Node cubes: the root's min plus bit * halved edge, level by level.
    k = len(levels)
    node_min = np.broadcast_to(lo.double().cpu().numpy(), (k, 3)).copy()
    node_edge = np.full(k, root_edge)
    for d in range(1, int(levels.max()) + 1):
        live = levels >= d
        half = np.where(live, node_edge / 2.0, node_edge)
        digit = (paths >> np.where(live, 3 * (levels - d), 0)) & 7
        bits = np.stack([(digit >> 2) & 1, (digit >> 1) & 1, digit & 1], 1)
        node_min = node_min + np.where(live[:, None], bits * half[:, None], 0.0)
        node_edge = half
    encodings = np.array([_encoding(e, resolution) for e in node_edge])

    # Positions relative to each node's cube, and the attributes.
    per_point = torch.repeat_interleave(
        torch.arange(k, device=dev), torch.as_tensor(counts, device=dev))
    pmin = torch.as_tensor(node_min, device=dev).to(dtype)[per_point]
    pedge = torch.as_tensor(node_edge, device=dev).to(dtype)[per_point]
    t = ((p[point_order] - pmin) / pedge[:, None])
    t = torch.nan_to_num(t, nan=0.0).clamp(0.0, 1.0)
    del pmin, pedge
    enc_pt = torch.as_tensor(encodings, device=dev)[per_point]
    col = torch.as_tensor(color, device=dev)[point_order].cpu().numpy()
    inten = torch.as_tensor(intensity, device=dev)[point_order].cpu().numpy()
    xyz: Dict[int, np.ndarray] = {}
    for enc, (tmax, np_type) in {1: (255.0, np.uint8), 2: (65535.0, np.uint16),
                                 3: (None, np.float32),
                                 4: (None, np.float64)}.items():
        rows = torch.nonzero(enc_pt == enc).flatten()
        if len(rows) == 0:
            continue
        v = t[rows]
        v = (v * tmax).to(torch.int32) if tmax else v
        xyz[enc] = (rows.cpu().numpy(), v.cpu().numpy().astype(np_type))
    del t

    files: Dict[str, bytes] = {}
    for i in np.flatnonzero(counts):
        a, b = int(offsets[i]), int(offsets[i + 1])
        rows, vals = xyz[int(encodings[i])]
        lo_r, hi_r = np.searchsorted(rows, [a, b])
        stem = node_name(int(levels[i]), int(paths[i]))
        files[stem + ".xyz"] = vals[lo_r:hi_r].tobytes()
        files[stem + ".rgb"] = col[a:b].tobytes()
        files[stem + ".intensity"] = inten[a:b].astype("<f4").tobytes()
    tree = RefOctree(depth, lo.double().cpu().numpy(), root_edge,
                     (lo.double().cpu().numpy(), hi.double().cpu().numpy()),
                     levels, paths, counts, node_min, node_edge, encodings,
                     point_order, offsets, files)
    tree.files["meta.pb"] = meta_bytes(tree, resolution)
    return tree


def decoded_positions(tree: RefOctree, position: np.ndarray) -> np.ndarray:
    """(N, 3) f64: each input point as a reader decodes it from its node,
    in input order."""
    n = len(position)
    out = np.empty((n, 3))
    order = tree.point_order.cpu().numpy()
    for i in np.flatnonzero(tree.counts):
        a, b = int(tree.offsets[i]), int(tree.offsets[i + 1])
        stem = node_name(int(tree.levels[i]), int(tree.paths[i]))
        enc = int(tree.encodings[i])
        raw = np.frombuffer(tree.files[stem + ".xyz"], dtype={
            1: np.uint8, 2: np.uint16, 3: np.float32, 4: np.float64}[enc])
        t = raw.reshape(-1, 3).astype(np.float64)
        if enc == 1:
            t = t / 255.0
        elif enc == 2:
            t = t / 65535.0
        out[order[a:b]] = t * tree.node_edge[i] + tree.node_min[i]
    return out


def read_directory(directory: str) -> Dict[str, bytes]:
    import os

    out = {}
    for name in os.listdir(directory):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = f.read()
    return out


def describe(name: str, got: bytes, want: bytes) -> str:
    """Where two versions of one file part: sizes, the first differing
    byte, and for a position file the values there."""
    m = min(len(got), len(want))
    diff = np.flatnonzero(np.frombuffer(got[:m], np.uint8)
                          != np.frombuffer(want[:m], np.uint8))
    at = int(diff[0]) if len(diff) else m
    text = (f"{name}: {len(got)} B, reference {len(want)} B, {len(diff)} "
            f"bytes differ, first at {at}")
    if name.endswith(".xyz") and len(got) == len(want):
        for dt in (np.uint16, np.float32, np.uint8):
            if len(got) % (3 * np.dtype(dt).itemsize) == 0:
                g = np.frombuffer(got, dt).reshape(-1, 3)
                w = np.frombuffer(want, dt).reshape(-1, 3)
                rows = np.flatnonzero((g != w).any(1))
                text += (f"; as {np.dtype(dt).name}: {len(rows)} of {len(g)} "
                         f"rows differ, e.g. row {rows[:3].tolist()}: "
                         f"{g[rows[:3]].tolist()} vs {w[rows[:3]].tolist()}")
                break
    return text


def compare_files(want: Dict[str, bytes], got: Dict[str, bytes],
                  notes: list = None) -> Dict[str, int]:
    """Files of an octree against the reference's: how many differ in
    their bytes, are missing or are extra, and how many bytes differ.
    `notes` collects a description of the first few that differ."""
    differ = 0
    bytes_off = 0
    for name in sorted(set(got) & set(want)):
        a, b = got[name], want[name]
        if a != b:
            if notes is not None and differ < 4:
                notes.append(describe(name, a, b))
            differ += 1
            m = min(len(a), len(b))
            bytes_off += int(np.count_nonzero(
                np.frombuffer(a[:m], np.uint8) != np.frombuffer(b[:m], np.uint8)))
            bytes_off += abs(len(a) - len(b))
    return {"files_differ": differ, "files_missing": len(set(want) - set(got)),
            "files_extra": len(set(got) - set(want)), "bytes_differ": bytes_off}
