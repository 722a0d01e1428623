"""Traffic kind `select`: the viewer's node selection for each frame of an
orbit, through the program's `DeviceCullSession`, in a closed loop.

Set-up builds the seed's cloud into an octree (the program's
`build_octree`, on the card), opens the session over its node table as the
viewer does, and draws the orbit: `frames` camera matrices a revolution
around the cloud's bounding box, as the headless viewer flies it (800 x
600, 45 degree field of view, from the box's centre out by its diagonal
and up by half of it); --seed draws the cloud and the frame the window
starts from.  Each unit
is one frame: the frustum from the matrix, one session step, and the
node-id list capped as the viewer caps it.

After the window, a seeded sample of the frames served is judged against
the reference selection over the reference build's nodes.
"""

from __future__ import annotations

import math
import os

import numpy as np

from reference import cull as ref_cull
from reference import octree as ref_octree

SPAN = "bench.frame"


def _rotation(axis: int, angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    r = np.eye(3)
    r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
    return r


def orbit(box_min, box_max, frames: int, width: int, height: int,
          start: float) -> list:
    """Camera matrices (clip from world) of the headless viewer's orbit:
    position centre + diag * (cos a, sin a, 0.5), yaw a + pi/2 about z,
    pitch pi/3 about the camera's x, perspective of 45 degrees at near 0.1
    and far 10,000 (the viewer's camera)."""
    center = (np.asarray(box_min) + np.asarray(box_max)) / 2
    diag = float(np.linalg.norm(np.asarray(box_max) - np.asarray(box_min)))
    near, far, fovy = 0.1, 10000.0, math.pi / 4
    ymax = near * math.tan(fovy / 2)
    xmax = ymax * width / height
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = near / xmax, near / ymax
    proj[2, 2] = -(far + near) / (far - near)
    proj[2, 3] = -(2.0 * far * near) / (far - near)
    proj[3, 2] = -1.0
    out = []
    for f in range(frames):
        a = start + 2 * math.pi * f / frames
        pos = center + diag * np.array([math.cos(a), math.sin(a), 0.5])
        rot = _rotation(2, a + math.pi / 2) @ _rotation(0, math.pi / 3)
        view = np.eye(4)
        view[:3, :3] = rot.T
        view[:3, 3] = -rot.T @ pos
        out.append(proj @ view)
    return out


def setup(ctx: dict) -> dict:
    from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
    from point_cloud_viewer_tpu_torch.octree.builder import build_octree
    from point_cloud_viewer_tpu_torch.octree.octree import Octree
    from point_cloud_viewer_tpu_torch.ops.culling import DeviceCullSession

    cfg, params = ctx["config"], ctx["cell"]["params"]
    cloud = ctx["generator"].generate(cfg, ctx["seed"])
    out = os.path.join(ctx["tmp"], "octree")
    build_octree(out, cfg["resolution"], PointsBatch(
        position=cloud["position"],
        attributes={"color": cloud["color"], "intensity": cloud["intensity"]}),
        device=ctx["device"])
    octree = Octree.from_directory(out)
    session = DeviceCullSession(octree.cube_mins, octree.cube_edges,
                                octree.num_points, device=ctx["device"])
    rng = np.random.default_rng([ctx["seed"], 1])
    pos = cloud["position"]
    mats = orbit(pos.min(0), pos.max(0), params["frames"], params["width"],
                 params["height"], 0.0)
    sample = set(int(i) for i in rng.choice(
        params["frames"], size=params["compare_frames"], replace=False))
    state = dict(ctx, cloud=cloud, octree=octree, session=session,
                 matrices=mats, sample=sample, kept={},
                 first=int(rng.integers(params["frames"])))
    for i in range(len(mats)):
        unit(state, i)
    state["kept"] = {}
    return state


def unit(state: dict, i: int) -> tuple:
    from point_cloud_viewer_tpu_torch.ops.culling import Frustum

    f = (i + state["first"]) % len(state["matrices"])
    order, sizes, visible = state["session"].step(
        Frustum.from_matrix4(state["matrices"][f]))
    count = min(int(visible.sum()), state["cell"]["params"]["node_cap"])
    ids = [state["octree"].node_ids[k] for k in order[:count]]
    if f in state["sample"] and f not in state["kept"]:
        state["kept"][f] = (ids, sizes[order[:count]])
    return 1, {"frame": f}


def end_to_end(state: dict, units: list, t_open: float) -> dict:
    from measure import percentile

    return {"select_ms_p95": percentile([u.seconds * 1e3 for u in units], 95)}


def layer_context(state: dict, units: list) -> dict:
    return {"ms": [u.seconds * 1e3 for u in units if u.ok],
            "nodes": len(state["octree"].num_points)}


def _reference(state: dict, dtype: str, frames: list) -> dict:
    """Each frame's reference: the listed [(level, path)] in draw order,
    their sizes, every node's size by key, and the keys of the nodes that
    touch the frustum's boundary to within the cloud's resolution (ties
    that rounding may put on either side)."""
    import torch

    cfg, cloud = state["config"], state["cloud"]
    tree = ref_octree.build(cloud["position"], cloud["color"], cloud["intensity"],
                            cfg["resolution"], cfg["max_points_per_node"],
                            device=state["device"])
    cap = state["cell"]["params"]["node_cap"]
    every = list(zip(tree.levels.tolist(), tree.paths.tolist()))
    out = {}
    for f in frames:
        ids, sizes, _, margin = ref_cull.select(
            state["matrices"][f], tree.node_min, tree.node_edge, tree.counts,
            cap, dtype=getattr(torch, dtype))
        ties = {every[k] for k in np.flatnonzero(
            np.abs(margin) <= cfg["resolution"])}
        out[f] = ([every[k] for k in ids], sizes[ids],
                  dict(zip(every, sizes.tolist())), ties)
    return out


def _judge(got: dict, want: dict) -> dict:
    """Per frame: the nodes listed by one side only (`node_set_gap`,
    summed over frames; a node that touches the frustum's boundary to
    within the cloud's resolution is left out, since rounding may put it
    on either side), the largest gap between a node's size on the two
    lists (`size_gap`, over nodes both list), and the largest step up in
    the reference's size along the judged list's order (`order_gap`)."""
    r = {"node_set_gap": 0, "order_gap": 0.0, "size_gap": 0.0}
    for f, (keys, sizes) in got.items():
        ref_keys, ref_sizes, ref_size, ties = want[f]
        listed = dict(zip(ref_keys, (float(x) for x in ref_sizes)))
        mine = dict(zip(keys, (float(x) for x in sizes)))
        r["node_set_gap"] += len((set(listed) ^ set(mine)) - ties)
        for k in set(listed) & set(mine):
            r["size_gap"] = max(r["size_gap"], abs(mine[k] - listed[k]))
        along = [ref_size[k] for k in keys if k in ref_size]
        if len(along) > 1:
            r["order_gap"] = max(r["order_gap"], float(np.max(np.diff(along))))
    return r


def check(state: dict, units: list) -> dict:
    state.pop("session", None)
    got = {f: ([(n.level, n.index) for n in ids], sizes)
           for f, (ids, sizes) in state["kept"].items()}
    return _judge(got, _reference(state, "float64", sorted(got)))


def control(state: dict) -> dict:
    """The reference selection in bfloat16, judged as the window's."""
    frames = sorted(state["sample"])
    low = _reference(state, "bfloat16", frames)
    return _judge({f: (k, s) for f, (k, s, _, _) in low.items()},
                  _reference(state, "float64", frames))


def close(state: dict) -> None:
    state.pop("session", None)
