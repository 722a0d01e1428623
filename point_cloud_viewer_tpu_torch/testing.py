"""Inputs and device readings shared by chip_smoke.py, kernel_ab.py and the
tests: a node table of IEEE corner cases for the cull, points on the
faces of a query OBB or frustum and S2 points on face boundaries for the
query filter, the x-ray splat reductions' inputs and outputs, and what
torch.profiler sees of a call on the card.

The profiler drops some or all of a session's device records now and then
(it never adds any): records near either end of a session, in a process
that has run for minutes (a K3 call's leading memset; late in
chip_smoke.py, a lone K5 call's only kernel in five sessions of five,
while sessions of five calls kept records).  So each session (`_session`)
waits SETTLE_S and puts a short spin kernel on the card before its first
call and after its last, and only the port's kernels (namespace pcv) and
memsets are counted; `kernel_split` averages over the records it keeps
and profiles again when it keeps none, and `device_ops` takes each name's
most over several profiles and raises when none of them saw a kernel of
the port.
"""

from __future__ import annotations

import os
import re
import time

import numpy as np

# IEEE corner cases of a node table: signed zeros, subnormals, magnitudes
# whose products and sums overflow, infinities and NaN.
CULL_SPECIAL = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, 1e38, -1e38, 3e38,
                         -3e38, np.inf, -np.inf, np.nan], dtype=np.float32)
# Seconds a profiler session waits, and clock cycles it spins the card
# (~0.5 ms at the H100's 1.98 GHz boost clock), before its first call and
# after its last.
SETTLE_S = 0.1
PAD_CYCLES = 1_000_000


def adversarial_node_table(k: int, seed: int):
    """A k-node cull table of IEEE corner cases beside ordinary cubes in
    [0, 1024]^3: about a third of the coordinates and edges are taken from
    CULL_SPECIAL, a sixth of the edges are negative, one node in 13 is
    empty.  -> f32 mins (k, 3), f32 edges (k,), i32 num_points (k,)."""
    rng = np.random.default_rng(seed)
    mins = (rng.random((k, 3)) * 1024.0).astype(np.float32)
    edges = (1024.0 / np.exp2(rng.integers(0, 8, k))).astype(np.float32)
    odd = rng.random((k, 3)) < 0.3
    mins[odd] = rng.choice(CULL_SPECIAL, int(odd.sum()))
    odd = rng.random(k) < 0.3
    edges[odd] = rng.choice(CULL_SPECIAL, int(odd.sum()))
    flip = rng.random(k) < 0.17
    edges[flip] = -edges[flip]
    num_points = np.full(k, 10, dtype=np.int32)
    num_points[::13] = 0
    return mins, edges, num_points


# Relative offsets of query face points from their face: most on it, some a
# few ulps to either side, some farther (rows the filter decides on the
# device beside rows in its band).
FACE_NUDGES = np.array([0.0] * 5 + [1e-16, -1e-16, 4e-16, -4e-16, 1e-14,
                                    -1e-14, 1e-11, -1e-11, 1e-7, -1e-7])


def _face_coords(rng, n: int, half) -> np.ndarray:
    """(n, 3) coordinates in the box [-half, half], each row on one of its
    six faces, nudged by FACE_NUDGES."""
    out = (rng.random((n, 3)) * 2.0 - 1.0) * half
    rows, axis = np.arange(n), rng.integers(0, 3, n)
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    out[rows, axis] = (sign * np.broadcast_to(half, (n, 3))[rows, axis]
                       * (1.0 + rng.choice(FACE_NUDGES, n)))
    return out


def obb_face_points(obb, n: int, seed: int) -> np.ndarray:
    """(n, 3) f64 query-frame points on the faces of `obb` (an Obb of either
    package), placed in the OBB's frame and mapped out by its pose."""
    rng = np.random.default_rng(seed)
    return obb.query_from_obb.transform_points(
        _face_coords(rng, n, obb.half_extent))


def frustum_plane_points(frustum, n: int, seed: int) -> np.ndarray:
    """(n, 3) f64 query-frame points on the six planes of `frustum` (a
    Frustum of either package): clip coordinates on the faces of [-1, 1]^3
    mapped out by query_from_clip."""
    rng = np.random.default_rng(seed)
    clip = _face_coords(rng, n, 1.0)
    m = frustum.query_from_clip
    q = clip @ m[:3, :3].T + m[:3, 3]
    w = clip @ m[3, :3].T + m[3, 3]
    return q / w[:, None]


def s2_face_points(n: int, seed: int) -> np.ndarray:
    """(n, 3) f64 ECEF points in the Earth's radius band over all six S2
    faces: a quarter random directions, a quarter with |x| == |y|, a
    quarter with |y| == |z| or |x| == |z| (argmax ties), a quarter on cube
    diagonals and axes; faces 4 and 5 (-y, -z) give ids with bit 63 set."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    q = n // 4
    d[q:2 * q, 1] = d[q:2 * q, 0] * rng.choice([-1.0, 1.0], q)
    rows, source = np.arange(2 * q, 3 * q), rng.integers(0, 2, q)
    d[rows, 2] = d[rows, source] * rng.choice([-1.0, 1.0], q)
    rest = n - 3 * q
    d[3 * q:] = rng.choice([-1.0, 0.0, 1.0], (rest, 3))
    d[3 * q:][~d[3 * q:].any(axis=1)] = [0.0, 0.0, -1.0]
    return d * rng.uniform(6.35e6, 6.39e6, (n, 1))


# K8's regions (csrc/query_mask.cu) by the names of query_mask_case.
QUERY_MASK_KINDS = ("box", "obb", "frustum", "web_mercator")
# query_mask_case's WebMercatorRect, normalized north-west and south-east.
QUERY_MASK_RECT = ((0.52, 0.30), (0.55, 0.33))


def query_mask_region(kind: str):
    """The region of query_mask_case: a box, a rotated OBB and a perspective
    frustum around the origin (tests/test_device_filter.py's), or a
    WebMercatorRect over Europe."""
    from .math.geometry import Aabb, Frustum, Isometry, Obb, Perspective
    from .math.web_mercator import WebMercatorCoord, WebMercatorRect

    if kind == "box":
        return Aabb(np.array([-5.0, -3.0, -8.0]), np.array([7.0, 9.0, 2.0]))
    if kind == "obb":
        return Obb(Isometry.from_axis_angle([1, 1, 0], 0.7,
                                            translation=[1.0, -2.0, 3.0]),
                   np.array([6.0, 4.0, 9.0]))
    if kind == "frustum":
        eye = Isometry.from_axis_angle([0, 1, 0], 0.4,
                                       translation=[0.0, 0.0, 30.0])
        return Frustum.new(eye, Perspective.from_fov(1.1, 0.9, 1.0, 60.0))
    nw, se = QUERY_MASK_RECT
    return WebMercatorRect(WebMercatorCoord(np.array(nw)),
                           WebMercatorCoord(np.array(se)))


def _rect_points(rect, n: int, rng) -> np.ndarray:
    """ECEF points of a WebMercatorRect's neighbourhood: a third inside, a
    third on its edges (exactly, or 1e-12 to either side in normalized
    units), a third within 0.05 of it; altitudes -100 to 5000 m."""
    from .math import wgs84
    from .math.web_mercator import web_mercator_to_lat_lng

    nw, se = rect.north_west.normalized, rect.south_east.normalized
    uv = nw - 0.05 + (se - nw + 0.1) * rng.random((n, 2))
    inside = np.arange(n) % 3 == 0
    uv[inside] = nw + (se - nw) * rng.random((int(inside.sum()), 2))
    edge = np.flatnonzero(np.arange(n) % 3 == 1)
    axis = rng.integers(0, 2, len(edge))
    side = np.where((rng.random(len(edge)) < 0.5)[:, None], nw, se)
    uv[edge, axis] = (side[np.arange(len(edge)), axis]
                      + rng.choice([0.0, 0.0, 1e-12, -1e-12], len(edge)))
    lat, lon = web_mercator_to_lat_lng(uv)
    return wgs84.geodetic_to_ecef(lat, lon, rng.uniform(-100.0, 5000.0, n))


def query_mask_case(kind: str, n: int, seed: int,
                    with_intervals: bool = False) -> tuple:
    """A node of n points for the query filter's region `kind` (one of
    QUERY_MASK_KINDS) -> (location, (n, 3) f64 positions, intervals,
    attributes).  Half the points lie near the region, half on its faces
    or edges (exactly, or nudged by FACE_NUDGES); with_intervals adds an
    f32 `intensity` in [0, 100) (NaN and both bounds sprinkled in) and a
    u16 `class` in [0, 10], with an interval on each; else both dicts are
    empty."""
    from .math.intervals import ClosedInterval
    from .query.location import location_for

    rng = np.random.default_rng(seed)
    region = query_mask_region(kind)
    if kind == "web_mercator":
        pts = _rect_points(region, n, rng)
    else:
        pts = rng.random((n, 3)) * 40.0 - 20.0
        half = n // 2
        if kind == "box":
            center = (region.mins + region.maxs) / 2
            pts[:half] = center + _face_coords(
                rng, half, (region.maxs - region.mins) / 2)
        elif kind == "obb":
            pts[:half] = obb_face_points(region, half, seed)
        else:
            pts[:half] = frustum_plane_points(region, half, seed)
    if not with_intervals:
        return location_for(region), pts, {}, {}
    intensity = (rng.random(n) * 100.0).astype(np.float32)
    intensity[::17] = 20.0
    intensity[5::17] = 60.0
    intensity[11::97] = np.nan
    attributes = {"intensity": intensity,
                  "class": rng.integers(0, 11, n).astype(np.uint16)}
    intervals = {"intensity": ClosedInterval(20.0, 60.0),
                 "class": ClosedInterval(3.0, 7.0)}
    return location_for(region), pts, intervals, attributes


def query_mask_host(location, positions, intervals, attributes) -> np.ndarray:
    """The host's mask of a query_mask_case: contains() and the interval
    filters."""
    with np.errstate(invalid="ignore"):
        keep = location.contains(positions)
    for name, interval in intervals.items():
        keep = keep & interval.contains(attributes[name])
    return keep


# query_decode_octree's stored encodings, by the resolution that gives each
# over its 40 m site (ops/codec.position_encoding_for).
QUERY_DECODE_RESOLUTIONS = {"u8": 0.5, "u16": 0.001, "f32": 1e-5,
                            "f64": 1e-9}
# Its scalar attributes beside colour and intensity, one of each column
# type K8 reads as stored, and a u64 one that it does not.
QUERY_DECODE_COLUMNS = {"a_u8": "u1", "a_u16": "<u2", "a_u32": "<u4",
                        "a_i8": "i1", "a_i16": "<i2", "a_i32": "<i4",
                        "a_f64": "<f8", "a_u64": "<u8"}
# A point of the site, in degrees and metres: the ECEF frame's east, north
# and up there are the site's axes.
QUERY_DECODE_SITE = (48.8566, 2.3522, 35.0)


def query_decode_octree(directory: str, encoding: str, seed: int = 5):
    """An octree of 80,000 points over a 40 m ECEF site (half of them in its
    lowest octant), built on the host into `directory` and stored in
    `encoding` (a key of QUERY_DECODE_RESOLUTIONS): a root of 10,004 rows,
    one child of 39,345 and seven under 10,000, so u8 and u16 nodes lie on
    both sides of ops/codec's native decode.  Colour, intensity (NaN and
    0.2, 0.6 sprinkled in) and QUERY_DECODE_COLUMNS, the latter registered
    in the returned Octree's attribute_data_types (an octree's meta records
    only colour and intensity)."""
    from .core.attributes import AttributeDataType
    from .core.points_batch import PointsBatch
    from .math import wgs84
    from .octree.builder import build_octree
    from .octree.octree import Octree

    rng = np.random.default_rng(seed)
    n = 80_000
    local = rng.random((n, 3)) * 40.0 - 20.0
    local[:n // 2] = rng.random((n // 2, 3)) * 20.0 - 20.0
    lat, lon, alt = QUERY_DECODE_SITE
    frame = wgs84.local_frame_from_lat_lng(lat, lon)
    ecef = frame.inverse().transform_points(local + [0.0, 0.0, alt])
    intensity = rng.random(n).astype(np.float32)
    intensity[::13] = 0.2
    intensity[7::13] = 0.6
    intensity[5::101] = np.nan
    attributes = {"color": rng.integers(0, 256, (n, 3), dtype=np.uint8),
                  "intensity": intensity}
    for name, dtype in QUERY_DECODE_COLUMNS.items():
        attributes[name] = rng.integers(0, 100, n).astype(dtype)
    build_octree(directory, QUERY_DECODE_RESOLUTIONS[encoding],
                 PointsBatch(position=ecef, attributes=attributes),
                 use_device=False)
    octree = Octree.from_directory(directory)
    for name, dtype in QUERY_DECODE_COLUMNS.items():
        octree.attribute_data_types[name] = AttributeDataType.from_array(
            np.zeros(1, dtype=dtype))
    return octree


def query_decode_regions(octree) -> dict:
    """Regions of each K8 kind over query_decode_octree's site, with a face
    through a point p0 of its root node as decoded: a box [c - e, c + e]
    and an OBB (no rotation) and an orthographic frustum over the same box,
    with c = p0 - (4, 0, 0) and e = (4, 6, 5), so p0 and the rows that share
    its x lie on a face, exactly (x - c is exactly 4); and a WebMercatorRect
    of about 80 m whose north-west corner is p0's projection.  -> {kind:
    location}."""
    from .math.geometry import Aabb, Frustum, Isometry, Obb
    from .math.web_mercator import (WebMercatorCoord, WebMercatorRect,
                                    ecef_to_web_mercator)
    from .octree.node_id import NodeId
    from .query.location import location_for

    p0 = octree.points_in_node(NodeId.root(), attributes=[]).position[17]
    c = p0 - [4.0, 0.0, 0.0]
    e = np.array([4.0, 6.0, 5.0])
    ortho = np.diag([0.25, 1.0 / 6.0, 0.2, 1.0])
    ortho[:3, 3] = -ortho.diagonal()[:3] * c
    nw = ecef_to_web_mercator(p0[None])[0]
    rect = WebMercatorRect(WebMercatorCoord(nw), WebMercatorCoord(nw + 2e-6))
    return {"box": location_for(Aabb(c - e, c + e)),
            "obb": location_for(Obb(Isometry(np.eye(3), c), e)),
            "frustum": location_for(Frustum.from_matrix4(ortho)),
            "web_mercator": location_for(rect)}


def query_decode_intervals(k: int) -> dict:
    """k intervals (0, 1 or 8) on query_decode_octree's attributes:
    intensity in [0.2, 0.6], then each K8 column type of
    QUERY_DECODE_COLUMNS in [10, 90]."""
    from .math.intervals import ClosedInterval

    names = ["intensity"] + [m for m in QUERY_DECODE_COLUMNS if m != "a_u64"]
    return {m: (ClosedInterval(0.2, 0.6) if m == "intensity"
                else ClosedInterval(10.0, 90.0)) for m in names[:k]}


def query_decode_node(directory: str, encoding: str, n: int, seed: int,
                      share: float):
    """One node of n random rows stored in `encoding` ("u16" or "f32")
    under `directory` as r.xyz, r.rgb and r.intensity, in a 40 m cube in
    ECEF, and a query of its colour and intensity in a box over `share` of
    the cube's x with intensity in [0.1, 0.9] -> (a cloud NodeDecode reads
    it from, the PointQuery)."""
    import types

    from .core.attributes import AttributeDataType
    from .io.node_io import OnDiskDataProvider, write_node_files
    from .math.geometry import Aabb
    from .math.intervals import ClosedInterval
    from .octree.octree import NodeMeta
    from .ops.codec import PositionEncoding
    from .query.point_query import PointQuery

    rng = np.random.default_rng(seed)
    if encoding == "u16":
        enc = PositionEncoding.UINT16
        stored = rng.integers(0, 65536, (n, 3)).astype("<u2")
    else:
        enc = PositionEncoding.FLOAT32
        stored = rng.random((n, 3)).astype("<f4")
    write_node_files(os.path.join(directory, "r"), stored, {
        "color": rng.integers(0, 256, (n, 3), dtype=np.uint8),
        "intensity": rng.random(n).astype("<f4")})
    meta = NodeMeta(n, enc, np.array([4.2e6, 1.7e5, 4.8e6]), 40.0)
    node = types.SimpleNamespace(
        node_meta=lambda node_id: meta,
        data_provider=OnDiskDataProvider(directory),
        attribute_data_types={"color": AttributeDataType.U8VEC3,
                              "intensity": AttributeDataType.F32})
    query = PointQuery(
        attributes=["color", "intensity"],
        location=Aabb(meta.cube_min - 1.0,
                      meta.cube_min + [40.0 * share, 41.0, 41.0]),
        filter_intervals={"intensity": ClosedInterval(0.1, 0.9)})
    return node, query


def query_decode_node_host(node, query, device=None):
    """query_decode_node's node by the host's route: read_node_batch, then
    the host's masks (or K8's f64 entry on `device`), then retain."""
    from .io.node_io import read_node_batch

    meta = node.node_meta("r")
    batch = read_node_batch(node.data_provider, "r",
                            node.attribute_data_types,
                            meta.position_encoding, meta.cube_min,
                            meta.edge_length)
    return query.filter_batch(batch, use_device=device is not None,
                              device=device)


def kernel_name(key: str) -> str:
    """A kernel's name without namespace, template arguments or
    parameters."""
    return re.sub(r"^(void )?pcv::\(anonymous namespace\)::", "",
                  key).split("<")[0].split("(")[0]


def _session(fn, calls: int):
    """A torch.profiler session around `calls` calls of fn, padded on both
    sides (SETTLE_S, PAD_CYCLES)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(SETTLE_S)
        torch.cuda._sleep(PAD_CYCLES)
        for _ in range(calls):
            fn()
        torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
    return prof


def kernel_split(fn, reps: int = 5, tries: int = 3) -> dict:
    """Device ms of each kernel of the port (namespace pcv) that fn launches
    once a call, by name: the mean of its launches over `reps` calls after
    a warm-up.  A profile that keeps no record of the port's kernels is
    taken again, up to `tries` times; {} when none keeps one.  Kernels of
    torch itself that fn runs (a clone for fresh state, say) are left
    out."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        out = {}
        for ev in _session(fn, reps).key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0.0)
            if us and ev.count and "pcv::" in ev.key:
                name = kernel_name(ev.key)
                out[name] = out.get(name, 0.0) + us / 1e3 / ev.count
        if out:
            return out
    return {}


def device_ops(fn, tries: int = 10) -> dict:
    """{"kernels": [names], "memsets": count}: the port's kernels and the
    memsets that one call of fn puts on the card, each name's most over
    `tries` profiles of one call after a warm-up (so fn runs 1 + tries
    times; late in chip_smoke.py five profiles of a K3 call all dropped
    its memset once).  Raises RuntimeError when no profile saw a kernel of
    the port."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    most = {}
    for _ in range(tries):
        counts = {}
        for ev in _session(fn, 1).events():
            if ev.device_type != DeviceType.CUDA:
                continue
            name = ("memset" if "memset" in ev.name.lower() else
                    kernel_name(ev.name) if "pcv::" in ev.name else None)
            if name:
                counts[name] = counts.get(name, 0) + 1
        for name, count in counts.items():
            most[name] = max(most.get(name, 0), count)
    memsets = most.pop("memset", 0)
    if not most:
        raise RuntimeError(f"no profile of {tries} saw a kernel of the port")
    return {"kernels": sorted(name for name, count in most.items()
                              for _ in range(count)),
            "memsets": memsets}


def xray_splat_inputs(n: int, image_size: int, seed: int,
                      step: float = 1.0 / 64.0) -> dict:
    """Seeded numpy inputs of the four x-ray splat reductions
    (xray/device_splat.py) over an image_size^2 tile: packed occupancy keys
    pix * 2048 + z (z in [0, 1024]), pixel ids, u8 colors, heights in
    [0, 46) m and intensities in [1, 100) on a `step` grid (1/64: the
    exactness condition; None: full f64), and bins from -3 to 6, a
    twentieth of them anywhere in +-2^40 (negative and wide bins), with the
    binned values (the colors as f64, then the intensity).  A tenth of the
    points share one pixel, so some sums run long."""
    rng = np.random.default_rng(seed)
    npx = image_size * image_size
    pix = rng.integers(0, npx, n)
    pix[: n // 10] = npx // 3
    z = rng.integers(0, 1025, n)
    height = rng.random(n) * 46.0
    intensity = 1.0 + rng.random(n) * 99.0
    if step is not None:
        height = np.round(height / step) * step
        intensity = np.round(intensity / step) * step
    color = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    bins = rng.integers(-3, 7, n)
    wide = rng.random(n) < 0.05
    bins[wide] = rng.integers(-2**40, 2**40, int(wide.sum()))
    vals = np.concatenate([color.astype(np.float64), intensity[:, None]], 1)
    return {"keys": pix * 2048 + z, "pix": pix, "color": color,
            "height": height, "intensity": intensity, "bins": bins,
            "vals": vals}


def xray_splat_outputs(inputs: dict, image_size: int, device) -> dict:
    """{reduction: tuple of numpy outputs} of the port's four reductions on
    `inputs` (xray_splat_inputs) on `device`; the moments for the heights
    and for the intensities."""
    from .xray import device_splat as DS

    i = inputs
    return {
        "occupancy": (DS.xray_occupancy_device(i["keys"], image_size,
                                               device),),
        "color_sums": DS.color_sums_device(i["pix"], i["color"], image_size,
                                           device),
        "height_moments": DS.moment_sums_device(i["pix"], i["height"],
                                                image_size, device),
        "intensity_moments": DS.moment_sums_device(
            i["pix"], i["intensity"], image_size, device),
        "binned": DS.binned_run_reduce_device(i["pix"], i["bins"], i["vals"],
                                              device),
    }


def same_bits(a, b) -> bool:
    """Equal dtypes, shapes and bytes (NaN matching NaN)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and (
        a.tobytes() == b.tobytes())


def xray_splat_differences(got: dict, want: dict) -> list:
    """The (reduction, output index) pairs whose arrays differ in dtype,
    shape or any bit."""
    return [(name, k) for name in want
            for k, (g, w) in enumerate(zip(got[name], want[name]))
            if not same_bits(g, w)]


def xray_points(n: int, seed: int, step=1.0 / 64.0):
    """A PointsBatch of n points over a 10 x 10 x 5 m box (z on a `step`
    grid unless step is None), u8 colors, intensities in [1, 100) on a 1/64
    grid and a `ts` attribute from -10 to 60, as
    tests/test_xray_strategies.py:232-250 draws them."""
    from .core.points_batch import PointsBatch

    rng = np.random.default_rng(seed)
    p = rng.random((n, 3)) * np.array([10.0, 10.0, 5.0])
    if step is not None:
        p[:, 2] = np.round(p[:, 2] / step) * step
    return PointsBatch(position=p, attributes={
        "color": rng.integers(0, 256, (n, 3), dtype=np.uint8),
        "intensity": (rng.integers(64, 6400, n) / 64.0).astype(np.float32),
        "ts": rng.random(n) * 70.0 - 10.0})


def xray_render(kind: str, kwargs: dict, batches, size: int, device):
    """The (size, size, 4) u8 tile that make_strategy(kind, device=device,
    **kwargs) renders from `batches` over xray_points' box."""
    from .math.geometry import Aabb
    from .xray.generation import make_strategy

    box = Aabb(np.zeros(3), np.array([10.0, 10.0, 5.0]))
    strategy = make_strategy(kind, device=device, **kwargs)
    for batch in batches:
        strategy.process(batch, box, size)
    return strategy.render(size)


def image_difference(a: np.ndarray, b: np.ndarray) -> tuple:
    """(pixels whose channels differ, the largest difference in a channel)
    of two u8 images of one shape."""
    if a.shape != b.shape:
        raise AssertionError(f"image shapes {a.shape} != {b.shape}")
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int((d.reshape(-1, d.shape[-1]).max(axis=1) > 0).sum()), int(
        d.max(initial=0))
