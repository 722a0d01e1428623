"""Which points a query yields: the upstream client's six query regions
and its interval filter, on decoded positions, in NumPy.

A query is plain data (see benchmark/traffic/query.py):
  {"kind": "aabb", "mins", "maxs"}            half open: mins <= p < maxs
  {"kind": "obb", "rotation", "translation", "half_extent"}
                                               |R^T (p - t)| <= half
  {"kind": "frustum", "clip_from_query"}      -1 < clip < 1 after the divide
  {"kind": "cell_union", "cells"}             the point's leaf cell in a cell
  {"kind": "web_mercator", "north_west", "south_east"}
                                               nw <= wm(p) < se
plus "intervals": {attribute: [lo, hi]}, closed, compared in f64.
"""

from __future__ import annotations

import numpy as np

from . import geo, s2


def contains(query: dict, p: np.ndarray) -> np.ndarray:
    kind = query["kind"]
    if kind == "aabb":
        return np.all((np.asarray(query["mins"]) <= p)
                      & (p < np.asarray(query["maxs"])), axis=1)
    if kind == "obb":
        local = (p - np.asarray(query["translation"])) @ np.asarray(
            query["rotation"])
        return np.all(np.abs(local) <= np.asarray(query["half_extent"]), axis=1)
    if kind == "frustum":
        m = np.asarray(query["clip_from_query"])
        clip = (p @ m[:3, :3].T + m[:3, 3]) / (p @ m[3, :3] + m[3, 3])[:, None]
        return np.all((clip > -1.0) & (clip < 1.0), axis=1)
    if kind == "cell_union":
        return s2.union_contains(query["cells"], s2.leaf_ids(p))
    if kind == "web_mercator":
        wm = geo.ecef_to_web_mercator(p)
        return np.all((np.asarray(query["north_west"]) <= wm)
                      & (wm < np.asarray(query["south_east"])), axis=1)
    raise ValueError(f"unknown query kind {kind!r}")


def selects(query: dict, p: np.ndarray, attributes: dict) -> np.ndarray:
    keep = contains(query, p)
    for name, (lo, hi) in query.get("intervals", {}).items():
        v = np.asarray(attributes[name], dtype=np.float64)
        keep &= (lo <= v) & (v <= hi)
    return keep
