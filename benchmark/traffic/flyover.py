"""Traffic kind `flyover`: the viewer's node selection over a city's node
table, each frame of a circling flight, through the program's normal path,
in a closed loop.

Set-up writes the seed's node table (the configuration's generator, a
meta.pb and no node files), opens it with the program's
`Octree.from_directory`, makes the cull session as the viewer makes it
(`viewer.render_loop.cull_session`: the frame of the root cube's centre)
and draws the flight: `frames` camera matrices a turn of a circle of
`radius_m` about the site's centre, `height_m` above the WGS84 ellipsoid
there, heading along the circle and pitched `pitch_deg` below the horizon;
`width` x `height` at a `fovy_deg` field of view, near 0.1 and far 10,000
(the viewer camera's planes).  The camera is built in the site's
east-north-up frame and mapped to ECEF.  --seed draws the table's sample
and the frame the window starts from.

Each unit is one frame: the frustum from the matrix, the session's capped
step (`node_cap` on the card), and the program's NodeId list of it
(`viewer.render_loop.node_id_list`), as the viewer's `_device_visible`.

After the window, `compare_frames` frames drawn from the seed are judged
against the reference selection (reference/cull.py) in f64 in the ECEF
frame over the generator's own table, computed in blocks of `block_nodes`
nodes and merged by its stable rule.  `select.py`'s rules hold, with one
more tie: where the cap binds, a visible node whose reference size lies
within `cap_gap` of the cap-th listed size, relative to that size, is a tie
at the cap, since the program's f32 sizes can swap such neighbours across
it.  `cap_gap` is also a reading: the farthest, relative to the cap-th
size, that a visible node listed by one side only lies from it, so a
swap across the cap deeper than the tie shows both there and in
`node_set_gap`.  A list shorter or longer than the reference's by more
than its frustum-boundary ties is counted in `node_set_gap` all the same,
so nodes dropped at the cap show.  The control is the reference in f32 in
the ECEF frame: the arithmetic of a session without an origin.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

from reference import cull as ref_cull
from reference.geo import enu_basis, geodetic_to_ecef

import harness

SPAN = "bench.frame"
_select = harness.load_module("traffic", "select")


def _perspective(params: dict) -> np.ndarray:
    near, far = params["near"], params["far"]
    ymax = near * math.tan(math.radians(params["fovy_deg"]) / 2)
    xmax = ymax * params["width"] / params["height"]
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = near / xmax, near / ymax
    proj[2, 2] = -(far + near) / (far - near)
    proj[2, 3] = -(2.0 * far * near) / (far - near)
    proj[3, 2] = -1.0
    return proj


def flight(site: dict, params: dict) -> list:
    """Camera matrices (clip from ECEF) of the circling flight, in f64."""
    lat, lon = (math.radians(a) for a in site["site_lat_lon_deg"])
    origin = geodetic_to_ecef(lat, lon, 0.0)
    basis = enu_basis(lat, lon)  # rows: east, north, up in ECEF
    enu_from_ecef = np.eye(4)
    enu_from_ecef[:3, :3] = basis
    enu_from_ecef[:3, 3] = -basis @ origin
    proj = _perspective(params)
    radius, pitch = params["radius_m"], math.radians(params["pitch_deg"])
    up = np.array([0.0, 0.0, 1.0])
    out = []
    for f in range(params["frames"]):
        a = 2 * math.pi * f / params["frames"]
        pos = np.array([radius * math.cos(a), radius * math.sin(a),
                        params["height_m"]])
        heading = np.array([-math.sin(a), math.cos(a), 0.0])
        forward = math.cos(pitch) * heading - math.sin(pitch) * up
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        rot = np.stack([right, np.cross(right, forward), -forward])
        view = np.eye(4)
        view[:3, :3] = rot
        view[:3, 3] = -rot @ pos
        out.append(proj @ view @ enu_from_ecef)
    return out


def setup(ctx: dict) -> dict:
    # A program without the viewer's capped session fails here, before the
    # table is made.
    from point_cloud_viewer_tpu_torch.octree.octree import Octree
    from point_cloud_viewer_tpu_torch.ops.culling import Frustum
    from point_cloud_viewer_tpu_torch.viewer.render_loop import (
        cull_session, node_id_list)

    cfg, params = ctx["config"], ctx["cell"]["params"]
    out = os.path.join(ctx["tmp"], "octree")
    tree = ctx["generator"].generate(cfg, ctx["seed"], out,
                                     device=ctx["device"])
    octree = Octree.from_directory(out)
    session = cull_session(octree, ctx["device"])
    mats = flight(cfg["generator_params"], params)
    rng = np.random.default_rng([ctx["seed"], 1])
    sample = set(int(i) for i in rng.choice(
        params["frames"], size=params["compare_frames"], replace=False))
    state = dict(ctx, tree=tree, octree=octree, session=session,
                 matrices=mats, sample=sample, kept={},
                 first=int(rng.integers(params["frames"])),
                 frustum=Frustum.from_matrix4, ids=node_id_list)
    for i in range(len(mats)):
        unit(state, i)
    state["kept"] = {}
    return state


def unit(state: dict, i: int) -> tuple:
    f = (i + state["first"]) % len(state["matrices"])
    order, sizes, seen = state["session"].step_capped(
        state["frustum"](state["matrices"][f]),
        state["cell"]["params"]["node_cap"])
    ids = state["ids"](state["octree"], order)
    if f in state["sample"] and f not in state["kept"]:
        state["kept"][f] = (ids, sizes)
    return 1, {"frame": f, "visible": seen}


def end_to_end(state: dict, units: list, t_open: float) -> dict:
    from measure import percentile

    return {"select_ms_p95": percentile([u.seconds * 1e3 for u in units], 95)}


def layer_context(state: dict, units: list) -> dict:
    return {"ms": [u.seconds * 1e3 for u in units if u.ok],
            "nodes": len(state["octree"].num_points)}


def summary(state: dict, units: list) -> list:
    seen = [u.info["visible"] for u in units]
    if not seen:
        return []
    cap = state["cell"]["params"]["node_cap"]
    return [f"flyover: {len(state['octree'].num_points)} nodes; visible a "
            f"frame: min {min(seen)}, median {int(np.median(seen))}; frames "
            f"that saw no more than the cap ({cap}): "
            f"{sum(s <= cap for s in seen)} of {len(seen)}"]


# --- the judge ------------------------------------------------------------


def reference(tree, matrix: np.ndarray, dtype: str, block: int) -> tuple:
    """reference/cull.select over the table in blocks of `block` nodes,
    merged by its stable rule: (order of every node, sizes, visible,
    margin)."""
    import torch

    parts = [ref_cull.select(matrix, tree.node_min[a:a + block],
                             tree.node_edge[a:a + block],
                             tree.counts[a:a + block], 0,
                             dtype=getattr(torch, dtype))[1:]
             for a in range(0, len(tree.counts), block)]
    sizes, visible, margin = (np.concatenate(p) for p in zip(*parts))
    priority = np.where(visible, sizes, -np.inf)
    return np.argsort(-priority, kind="stable"), sizes, visible, margin


def rows_of(tree, keys: list) -> np.ndarray:
    """Table rows of (level, path) keys, -1 where the table has none."""
    rows = np.full(len(keys), -1, dtype=np.int64)
    levels = np.array([k[0] for k in keys], dtype=np.int64)
    paths = np.array([k[1] for k in keys], dtype=np.int64)
    starts = np.searchsorted(tree.levels, np.arange(tree.levels.max() + 2))
    for level in np.unique(levels[levels < len(starts) - 1]):
        at = np.flatnonzero(levels == level)
        seg = tree.paths[starts[level]:starts[level + 1]]
        i = np.searchsorted(seg, paths[at])
        hit = i < len(seg)
        hit[hit] = seg[i[hit]] == paths[at][hit]
        rows[at[hit]] = starts[level] + i[hit]
    return rows


def judge(state: dict, got: dict, dtype: str = "float64") -> dict:
    """select.py's judge of each frame's (keys, sizes) against the
    reference in `dtype`, with the tie at the cap, the count of nodes a
    list lacks or adds beyond its boundary ties, and `cap_gap`.  Besides
    the limits' numbers: `cap_tied`, the most visible nodes of the table a
    frame within the tie at the cap; `cap_excused`, the nodes listed by one side only
    that it excused, over all frames; `cap_size_err`, the largest error of
    a listed size relative to the reference's, over nodes both list that
    are at most twice the cap-th size."""
    tree, params = state["tree"], state["cell"]["params"]
    cap, res = params["node_cap"], float(state["config"]["resolution"])
    width = float(state["cell"]["limits"]["cap_gap"])
    key = lambda k: (int(tree.levels[k]), int(tree.paths[k]))  # noqa: E731
    want, boundary, depth = {}, {}, {}
    tied, excused, size_err = 0, 0, 0.0
    for f, (keys, mine_sizes) in got.items():
        order, sizes, visible, margin = reference(
            tree, state["matrices"][f], dtype, params["block_nodes"])
        listed = order[:min(int(visible.sum()), cap)]
        mine = rows_of(tree, keys)
        rows = np.union1d(listed, mine[mine >= 0])
        ties = {key(k) for k in rows if abs(margin[k]) <= res}
        boundary[f] = set(ties)
        depth[f] = 0.0
        if visible.sum() > cap:
            last = float(sizes[listed[-1]])
            on_list = set(listed.tolist())
            apart = on_list ^ set(mine[mine >= 0].tolist())
            for k in apart:
                if visible[k] and key(k) not in boundary[f]:
                    depth[f] = max(depth[f],
                                   float(abs(sizes[k] - last) / last))
            near = visible & (np.abs(sizes - last) <= width * last)
            tied = max(tied, int(np.count_nonzero(near)))
            at_cap = {key(k) for k in rows if near[k]}
            excused += len({key(k) for k in apart} & (at_cap - boundary[f]))
            ties |= at_cap
            for k, s in zip(mine, mine_sizes):
                if k in on_list and sizes[k] <= 2 * last:
                    size_err = max(size_err,
                                   float(abs(s - sizes[k]) / sizes[k]))
        want[f] = ([key(k) for k in listed], sizes[listed],
                   {key(k): float(sizes[k]) for k in rows}, ties)
    r = _select._judge(got, want)
    for f, (keys, _) in got.items():
        apart = set(want[f][0]) ^ set(keys)
        r["node_set_gap"] += max(0, abs(len(keys) - len(want[f][0]))
                                 - len(apart & boundary[f]))
    r["cap_gap"] = max(depth.values(), default=0.0)
    r.update(cap_tied=tied, cap_excused=excused, cap_size_err=size_err)
    return r


def _log_cap(r: dict) -> dict:
    print(f"flyover judge: cap_gap {r['cap_gap']!r}; the tie at the cap "
          f"held at most {r['cap_tied']} visible nodes a frame and excused "
          f"{r['cap_excused']}; listed sizes near the cap off by at most "
          f"{r['cap_size_err']!r} of the reference's", file=sys.stderr)
    return r


def check(state: dict, units: list) -> dict:
    state.pop("session", None)
    got = {f: ([(n.level, n.index) for n in ids], sizes)
           for f, (ids, sizes) in state["kept"].items()}
    return _log_cap(judge(state, got))


def control(state: dict) -> dict:
    """The reference in f32 in the ECEF frame, judged as the window's."""
    tree, params = state["tree"], state["cell"]["params"]
    got = {}
    for f in sorted(state["sample"]):
        order, sizes, visible, _ = reference(
            tree, state["matrices"][f], "float32", params["block_nodes"])
        listed = order[:min(int(visible.sum()), params["node_cap"])]
        got[f] = ([(int(tree.levels[k]), int(tree.paths[k])) for k in listed],
                  sizes[listed])
    return _log_cap(judge(state, got))


def close(state: dict) -> None:
    state.pop("session", None)
