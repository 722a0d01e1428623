"""A city survey's node table, without its points: the octree that the
reference build would make of `num_points` points of `ecef_site`'s site,
sketched from a sample of them, written as a reference-format meta.pb.

- The sample: `sample_points` (M) points of the site's distribution, drawn
  by `ecef_site`'s own `_points` from --seed.
- The root cube and depth cap: the reference's (the sample's bounding box's
  min corner and longest side; the first level whose cell is at most the
  resolution, at most 21).
- The leaf rule: the reference's, with the threshold scaled to the sample,
  `max_points_per_node` x M / N: a cell splits while it holds more sample
  points than that, down to the depth cap.  Every cell that holds a sample
  point is a node, ancestors included.
- The counts: a leaf's sample count scaled by N / M (rounded), then the
  reference's promotion on counts: each node but the root passes the
  ceiling of an eighth of what it holds to its parent.  Every count is
  above 0; the cull reads only that.
- No node files: selection reads no node's points.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

import harness
from reference import octree as ref_octree


def _depth(edge: float, resolution: float) -> int:
    """The reference's depth cap (reference/octree.py build)."""
    depth = 1
    while depth < ref_octree.MAX_CODE_LEVEL and edge / (1 << depth) > resolution:
        depth += 1
    return depth


def sample_codes(cfg: dict, seed: int, device="cpu") -> tuple:
    """The seed's sample of the site, as `codes` gives it."""
    g = cfg["generator_params"]
    points = harness.load_module("generators", "ecef_site")._points(
        g, np.random.default_rng(seed), int(g["sample_points"]))
    return codes(points, float(cfg["resolution"]), device)


def codes(points: np.ndarray, resolution: float, device="cpu") -> tuple:
    """Points as the reference codes them: (sorted Morton codes at the
    depth cap, the bounding box's lo and hi, the root cube's edge, the
    depth cap)."""
    lo, hi = points.min(0), points.max(0)
    edge = float((hi - lo).max())
    depth = _depth(edge, resolution)
    dev = torch.device(device)
    p = torch.as_tensor(points, device=dev)
    scale = float(1 << depth)
    cells = torch.floor((p - torch.as_tensor(lo, device=dev)) / edge * scale)
    cells = cells.clamp(0, scale - 1).long()
    del p
    morton = (ref_octree._spread(cells[:, 0]) << 2) \
        | (ref_octree._spread(cells[:, 1]) << 1) | ref_octree._spread(cells[:, 2])
    del cells
    return torch.sort(morton).values, lo, hi, edge, depth


def table(cfg: dict, seed: int, device="cpu", sample=None) -> SimpleNamespace:
    """The node table in (level, path) order: levels, paths (int64), counts,
    node_min (K, 3) f64, node_edge (K,), encodings, bbox, depth, threshold
    and leaf_points (the sample points each leaf holds, 0 for the others).
    `sample`: `sample_codes`' result (or `codes`' of other points)."""
    m = int(cfg["generator_params"]["sample_points"])
    n = int(cfg["num_points"])
    resolution = float(cfg["resolution"])
    threshold = float(cfg["max_points_per_node"]) * m / n
    sorted_codes, lo, hi, edge, depth = sample or sample_codes(cfg, seed,
                                                               device)
    dev = sorted_codes.device

    # Top down: the cells of each level, their sample counts, and which
    # are leaves; the points of cells that split go on to the next level.
    paths = [torch.zeros(1, dtype=torch.int64, device=dev)]
    held = [torch.zeros(1, dtype=torch.int64, device=dev)]  # leaf counts
    active = sorted_codes
    for level in range(1, depth + 1):
        if len(active) == 0:
            break
        key = active >> (3 * (depth - level))
        uniq, inverse, counts = torch.unique_consecutive(
            key, return_inverse=True, return_counts=True)
        leaf = (counts <= threshold) | (level == depth)
        paths.append(uniq)
        held.append(torch.where(leaf, counts, 0))
        active = active[~leaf[inverse]]
    del active

    # Bottom up: each node holds its leaf points (scaled) and what its
    # children pass; it passes ceil(held / 8) on, the root keeps all.
    kept = [None] * len(paths)
    passed = None
    for level in range(len(paths) - 1, -1, -1):
        at = torch.round(held[level].double() * (n / m)).long()
        if passed is not None:
            parent = torch.searchsorted(paths[level], paths[level + 1] >> 3)
            at = at.index_add(0, parent, passed)
        passed = (at + 7) // 8
        kept[level] = at - passed if level else at

    levels = np.concatenate([np.full(len(pa), lv, np.int64)
                             for lv, pa in enumerate(paths)])
    path = torch.cat(paths).cpu().numpy()
    count = torch.cat(kept).cpu().numpy()
    leaf_points = torch.cat(held).cpu().numpy()
    digits = _cells(levels, path)
    node_edge = edge / np.exp2(levels)
    node_min = lo + digits * node_edge[:, None]
    enc = np.array([ref_octree._encoding(edge / 2.0 ** lv, resolution)
                    for lv in range(len(paths))])
    return SimpleNamespace(levels=levels, paths=path, counts=count,
                           node_min=node_min, node_edge=node_edge,
                           encodings=enc[levels], bbox=(lo, hi), depth=depth,
                           threshold=threshold, leaf_points=leaf_points)


def _cells(levels: np.ndarray, paths: np.ndarray) -> np.ndarray:
    """(K, 3) f64 integer cell coordinates of each node at its level: x, y
    and z from every third bit of the path, x the most significant."""
    out = np.zeros((len(paths), 3), dtype=np.int64)
    for d in range(int(levels.max(initial=0))):
        digit = paths >> (3 * d)
        for axis in range(3):
            out[:, axis] |= ((digit >> (2 - axis)) & 1) << d
    return out.astype(np.float64)


def generate(cfg: dict, seed: int, directory: str, device="cpu") -> SimpleNamespace:
    """The table, with its meta.pb written into `directory`."""
    tree = table(cfg, seed, device)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "meta.pb"), "wb") as f:
        f.write(ref_octree.meta_bytes(tree, float(cfg["resolution"])))
    return tree
