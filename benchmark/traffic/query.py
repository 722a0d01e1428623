"""Traffic kind `query`: region queries through the program's
`PointCloudClient`, one at a time in a closed loop, each drained to its
last batch.

Set-up builds the seed's cloud into an octree (the program's
`build_octree`, on the card), opens one client with its default threads and
batch, draws the mix and runs each query kind twice to warm up.  The mix
holds `distinct_queries` queries in equal shares of the cell's `kinds`
(any of KINDS), each centred on a point drawn from the site's
distribution, with a horizontal half-extent drawn log-uniform from
`half_extent_m` and the site's whole altitude range.  The mix comes from
the cell's `mix_seed`, so every seed serves the same queries; --seed draws
the cloud and the order in which the window serves them, round and round.
A mix of some hundreds of queries lets a tail rest on many queries of
every kind, not on a few repeated ones.

After the window, a seeded sample of the queries served (and the one that
yielded most points) is judged against the reference: the points a reader
decodes from the reference build, selected by the reference regions.
"""

from __future__ import annotations

import math
import os

import numpy as np

from reference import geo, regions, s2
from reference import octree as ref_octree

SPAN = "bench.query"
KINDS = ("aabb", "obb", "frustum", "cell_union", "web_mercator",
         "aabb_intensity", "obb_intensity")
S2_EDGE_RAD = math.sqrt(4 * math.pi / 6)  # a level-0 cell's mean edge
EARTH_M = 6_371_000.0


# --- the mix, as plain data -------------------------------------------------


def _perspective(fovy: float, aspect: float, near: float, far: float):
    ymax = near * math.tan(fovy / 2)
    xmax = ymax * aspect
    m = np.zeros((4, 4))
    m[0, 0] = near / xmax
    m[1, 1] = near / ymax
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def _plan_one(kind: str, center: np.ndarray, rng, p: dict, alt: tuple) -> dict:
    lat, lon, _ = geo.ecef_to_geodetic(center)
    lat, lon = float(lat), float(lon)
    e, n, u = geo.enu_basis(lat, lon)
    mid, half_h = (alt[0] + alt[1]) / 2, (alt[1] - alt[0]) / 2
    origin = geo.geodetic_to_ecef(lat, lon, mid)
    h = math.exp(rng.uniform(*np.log(p["half_extent_m"])))
    yaw = rng.uniform(0.0, 2 * math.pi)
    ey = math.cos(yaw) * e + math.sin(yaw) * n
    ny = -math.sin(yaw) * e + math.cos(yaw) * n
    reach = math.sqrt(2 * h * h + half_h * half_h)
    q: dict = {"kind": kind.replace("_intensity", ""), "center": origin}
    if kind.startswith("aabb"):
        corners = np.array([origin + a * h * e + b * h * n + c * half_h * u
                            for a in (-1, 1) for b in (-1, 1) for c in (-1, 1)])
        q.update(mins=corners.min(0), maxs=corners.max(0))
        reach = float(np.linalg.norm((q["maxs"] - q["mins"]) / 2))
    elif kind.startswith("obb"):
        q.update(rotation=np.stack([ey, ny, u], axis=1), translation=origin,
                 half_extent=np.array([h, h, half_h]))
    elif kind == "frustum":
        height = p["frustum_eye_m"]
        eye = origin + (half_h + height) * u
        rot = np.stack([ey, ny, u], axis=1)  # looks down -u
        view = np.eye(4)
        view[:3, :3] = rot.T
        view[:3, 3] = -rot.T @ eye
        near, far = height / 2, height + 2 * half_h
        m = _perspective(2 * math.atan(h / (height + half_h)), 1.0, near, far)
        q.update(clip_from_query=m @ view)
        inv = np.linalg.inv(q["clip_from_query"])
        ndc = np.array([[x, y, z, 1.0] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)])
        hc = ndc @ inv.T
        reach = float(np.linalg.norm(hc[:, :3] / hc[:, 3:] - origin, axis=1).max())
    elif kind == "cell_union":
        level = int(rng.choice(p["s2_levels"]))
        want = int(rng.integers(1, p["s2_max_cells"] + 1))
        edge = S2_EDGE_RAD * EARTH_M / (1 << level)
        cells = []
        for de, dn in ((0, 0), (1, 0), (0, 1), (1, 1), (-1, 0), (0, -1),
                       (-1, -1), (1, -1), (-1, 1)):
            pt = center + 0.8 * edge * (de * e + dn * n)
            c = s2.parent(int(s2.leaf_ids(pt[None])[0]), level)
            if c not in cells:
                cells.append(c)
            if len(cells) == want:
                break
        q.update(cells=sorted(cells), level=level)
        reach = 4 * edge + half_h + 100.0
    else:  # web_mercator
        zoom = int(p["web_mercator_zoom"])
        scale = float(256 << zoom)
        tile = np.floor(geo.lat_lng_to_web_mercator(lat, lon) * (1 << zoom))
        lo_px, hi_px = tile * 256.0, tile * 256.0 + 256.0
        q.update(zoom=zoom, lo_px=lo_px, hi_px=hi_px,
                 north_west=lo_px / scale, south_east=hi_px / scale)
        reach = 2 * EARTH_M * 2 * math.pi / (1 << zoom) + half_h
    if kind.endswith("intensity"):
        q["intervals"] = {"intensity": list(p["intensity_interval"])}
    q["reach"] = reach + 100.0
    q["label"] = kind
    return q


def plan(cfg: dict, generator, params: dict) -> list:
    """The mix: the same queries for every seed, drawn from the cell's
    `mix_seed`, centred on points of the configuration's distribution."""
    rng = np.random.default_rng(params["mix_seed"])
    count = int(params["distinct_queries"])
    unknown = set(params["kinds"]) - set(KINDS)
    if unknown:
        raise ValueError(f"unknown query kinds {sorted(unknown)}")
    kinds = [params["kinds"][k % len(params["kinds"])] for k in range(count)]
    centers = generator.sample_points(cfg, rng, count)
    altitude = tuple(cfg["generator_params"]["altitude_m"])
    return [_plan_one(k, c, rng, params, altitude) for k, c in zip(kinds, centers)]


def _program_query(q: dict):
    """The plain query as the program's PointQuery."""
    from point_cloud_viewer_tpu_torch.math.geometry import (
        Aabb, Frustum, Isometry, Obb)
    from point_cloud_viewer_tpu_torch.math.intervals import ClosedInterval
    from point_cloud_viewer_tpu_torch.math.web_mercator import WebMercatorRect
    from point_cloud_viewer_tpu_torch.query.point_query import PointQuery
    from point_cloud_viewer_tpu_torch.s2_cells.cell_union import CellUnion

    kind = q["kind"]
    if kind == "aabb":
        loc = Aabb(q["mins"], q["maxs"])
    elif kind == "obb":
        loc = Obb(Isometry(q["rotation"], q["translation"]), q["half_extent"])
    elif kind == "frustum":
        loc = Frustum.from_matrix4(q["clip_from_query"])
    elif kind == "cell_union":
        loc = CellUnion(q["cells"])
    else:
        loc = WebMercatorRect.from_zoomed_coordinates(q["lo_px"], q["hi_px"],
                                                      q["zoom"])
    return PointQuery(
        attributes=["color", "intensity"], location=loc,
        filter_intervals={k: ClosedInterval(*v)
                          for k, v in q.get("intervals", {}).items()})


# --- the kind ---------------------------------------------------------------


def setup(ctx: dict) -> dict:
    from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
    from point_cloud_viewer_tpu_torch.octree.builder import build_octree
    from point_cloud_viewer_tpu_torch.octree.octree import Octree
    from point_cloud_viewer_tpu_torch.query.client import PointCloudClient

    cfg, params = ctx["config"], ctx["cell"]["params"]
    cloud = ctx["generator"].generate(cfg, ctx["seed"])
    out = os.path.join(ctx["tmp"], "octree")
    build_octree(out, cfg["resolution"], PointsBatch(
        position=cloud["position"],
        attributes={"color": cloud["color"], "intensity": cloud["intensity"]}),
        device=ctx["device"])
    client = PointCloudClient([Octree.from_directory(out)], device_filter=True,
                              device=ctx["device"])
    queries = plan(cfg, ctx["generator"], params)
    rng = np.random.default_rng([ctx["seed"], 2])
    sample = set(int(i) for i in rng.choice(
        len(queries), size=min(params["compare_queries"], len(queries)),
        replace=False))
    state = dict(ctx, cloud=cloud, client=client, queries=queries,
                 order=rng.permutation(len(queries)),
                 program=[_program_query(q) for q in queries], sample=sample,
                 kept={}, largest=(-1, None, None))
    kinds = params["kinds"]
    for i in range(2 * len(kinds)):
        j = next(k for k, q in enumerate(queries)
                 if q["label"] == kinds[i % len(kinds)])
        _serve(state, j)
    return state


def _serve(state: dict, j: int) -> tuple:
    parts = list(state["client"].stream(state["program"][j]))
    return sum(len(b) for b in parts), parts


def _gather(parts: list) -> dict:
    if not parts:
        return {"position": np.empty((0, 3)), "color": np.empty((0, 3), np.uint8),
                "intensity": np.empty(0, np.float32)}
    return {"position": np.concatenate([b.position for b in parts]),
            "color": np.concatenate([b.attributes["color"] for b in parts]),
            "intensity": np.concatenate([b.attributes["intensity"]
                                         for b in parts])}


def unit(state: dict, i: int) -> tuple:
    j = int(state["order"][i % len(state["queries"])])
    n, parts = _serve(state, j)
    # Batches are kept as yielded; they are joined after the window.
    if j in state["sample"] and j not in state["kept"]:
        state["kept"][j] = parts
    if n > state["largest"][0]:
        state["largest"] = (n, j, parts)
    return n, {"query": j}


def end_to_end(state: dict, units: list, t_open: float) -> dict:
    from measure import percentile

    ms = [u.seconds * 1e3 for u in units]
    return {"query_ms_p95": percentile(ms, 95)}


def summary(state: dict, units: list) -> list:
    """Per query kind: queries, median and largest ms, median points, and
    how many of its queries lie at or above the 95th percentile."""
    from measure import percentile

    if not units:
        return []
    tail = percentile([u.seconds * 1e3 for u in units], 95)
    lines = []
    for label in state["cell"]["params"]["kinds"]:
        mine = [u for u in units
                if state["queries"][u.info["query"]]["label"] == label]
        if mine:
            ms = sorted(u.seconds * 1e3 for u in mine)
            pts = sorted(u.work for u in mine)
            lines.append(f"{label}: {len(mine)} queries, median "
                         f"{ms[len(ms) // 2]:.3f} ms, max {ms[-1]:.3f} ms, "
                         f"median {pts[len(pts) // 2]} points, "
                         f"{sum(m >= tail for m in ms)} at or above the p95")
    return lines


def layer_context(state: dict, units: list) -> dict:
    return {"ms": [u.seconds * 1e3 for u in units if u.ok]}


def _answers(state: dict, decoded: np.ndarray, which: list) -> dict:
    """The reference's answer to each query in `which`."""
    import torch

    cloud = state["cloud"]
    dev = torch.device(state["device"])
    pts = torch.as_tensor(decoded, device=dev)
    out = {}
    for j in which:
        q = state["queries"][j]
        near = torch.nonzero(((pts - torch.as_tensor(q["center"], device=dev))
                              ** 2).sum(1) <= q["reach"] ** 2).flatten()
        rows = near.cpu().numpy()
        keep = regions.selects(q, decoded[rows],
                               {"intensity": cloud["intensity"][rows]})
        rows = rows[keep]
        out[j] = {"position": decoded[rows], "color": cloud["color"][rows],
                  "intensity": cloud["intensity"][rows]}
    return out


def _row_order(a: dict) -> np.ndarray:
    """Rows sorted by position (0.1 mm), then colour, then intensity."""
    keys = np.floor(a["position"] * 1e4).astype(np.int64)
    return np.lexsort((a["intensity"], *a["color"].T[::-1], *keys.T[::-1]))


def _judge(got: dict, want: dict, resolution: float) -> dict:
    """Counts, positions and attributes of two answers, rows matched by
    sorting on positions rounded to 0.1 mm, then on colour and intensity:
    points that decode to one position are told apart by their attributes,
    not by the order in which each side lists them."""
    r = {"count_gap": 0, "position_gap_res": 0.0, "attribute_gap": 0}
    for j, w in want.items():
        g = got[j]
        if len(g["position"]) != len(w["position"]):
            r["count_gap"] += abs(len(g["position"]) - len(w["position"]))
            continue
        if len(w["position"]) == 0:
            continue
        og, ow = (_row_order(a) for a in (g, w))
        r["position_gap_res"] = max(r["position_gap_res"], float(np.abs(
            g["position"][og] - w["position"][ow]).max()) / resolution)
        r["attribute_gap"] += int(np.count_nonzero(
            (g["color"][og] != w["color"][ow]).any(1)
            | (g["intensity"][og] != w["intensity"][ow])))
    return r


def _served(state: dict) -> dict:
    got = {j: _gather(parts) for j, parts in state["kept"].items()}
    n, j, parts = state["largest"]
    if j is not None:
        got[j] = _gather(parts)
    return got


def _reference_answers(state: dict, dtype: str, which: list) -> dict:
    import torch

    cfg, cloud = state["config"], state["cloud"]
    tree = ref_octree.build(cloud["position"], cloud["color"], cloud["intensity"],
                            cfg["resolution"], cfg["max_points_per_node"],
                            device=state["device"], dtype=getattr(torch, dtype))
    return _answers(state, ref_octree.decoded_positions(tree, cloud["position"]),
                    which)


def check(state: dict, units: list) -> dict:
    state.pop("client", None)
    got = _served(state)
    return _judge(got, _reference_answers(state, "float64", sorted(got)),
                  state["config"]["resolution"])


def control(state: dict) -> dict:
    """The reference's answers from a build in float32, judged as the
    window's answers."""
    which = sorted(state["sample"])
    return _judge(_reference_answers(state, "float32", which),
                  _reference_answers(state, "float64", which),
                  state["config"]["resolution"])


def close(state: dict) -> None:
    state.pop("client", None)
