"""Entry points of the port (twins of the repository's __graft_entry__.py).

* entry(device) -- the single-device step: per-frame frustum cull + LOD
  node selection over a synthetic 4096-node table (the viewer's inner
  loop; K5 on the card), returned as a function and its tensors.
* dryrun_multichip(n_devices, device) -- the multi-device build end to end
  over an n-shard mesh: the f32 stats step, the skewed capacity-overflow
  retry of the exact sort, a 2,000,003-point Earth-surface build on the
  mesh byte-compared with the single-device build, and geodesic queries
  over the mesh-built cloud.

Shards may share a device: on a machine with fewer cards than shards,
shard i runs on card i mod (cards), the counterpart of the JAX dry run's
virtual CPU devices; with device="cpu" every shard is a CPU shard.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from .device import resolve_device

# dryrun_multichip's sizes (__graft_entry__.py:123-181).
STATS_POINTS_PER_SHARD = 256
SKEW_POINTS = 64_000
BUILD_POINTS = 2_000_003  # odd: exercises the pad-to-mesh-multiple path


def entry(device="cuda"):
    """__graft_entry__.py:14-43: (frustum_cull_lod_select, its tensors on
    `device`) for one frame over a synthetic 4096-node table."""
    from .math.geometry import Frustum, Isometry, Perspective
    from .ops.culling import (
        frustum_axes_and_projections,
        frustum_cull_lod_select,
    )

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    k = 4096  # synthetic node table
    levels = rng.integers(0, 8, k)
    edges = (100.0 / np.exp2(levels)).astype(np.float32)
    mins = (rng.random((k, 3)) * 100.0).astype(np.float32)
    num_points = rng.integers(0, 100_000, k).astype(np.int32)

    eye = Isometry.from_axis_angle([0, 1, 0], 0.3,
                                   translation=[50.0, 50.0, 180.0])
    frustum = Frustum.new(eye, Perspective.from_fov(1.3, 1.2, 0.5, 500.0))
    axes, qmin, qmax = frustum_axes_and_projections(frustum)

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    example_args = (
        put(frustum.clip_from_query), put(axes), put(qmin), put(qmax),
        put(mins), put(edges), put(num_points, torch.int32),
    )
    return frustum_cull_lod_select, example_args


def _dryrun_mesh(n_devices: int, device):
    """n shards over `device`'s type: CPU shards, or the visible cards in
    turn."""
    from .parallel.mesh import make_mesh

    if resolve_device(device).type == "cpu":
        return make_mesh(n_devices, device="cpu")
    cards = make_mesh(device=device)
    return make_mesh(devices=[cards[i % len(cards)]
                              for i in range(n_devices)])


def _dirs_byte_equal(a: str, b: str) -> int:
    files = sorted(os.listdir(a))
    if files != sorted(os.listdir(b)):
        raise AssertionError(f"file sets differ: {len(files)} vs "
                             f"{len(os.listdir(b))}")
    for name in files:
        with open(os.path.join(a, name), "rb") as f:
            x = f.read()
        with open(os.path.join(b, name), "rb") as f:
            y = f.read()
        if x != y:
            raise AssertionError(f"{name} differs between the mesh and the "
                                 "single-device builds")
    return len(files)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """__graft_entry__.py:86-254 on an n-shard mesh of `device`; raises on
    any disagreement, prints one summary line and returns its numbers."""
    from .core.points_batch import PointsBatch
    from .math.wgs84 import local_frame_from_lat_lng
    from .octree.builder import build_octree
    from .ops import morton
    from .parallel.sharded_build import (
        make_sharded_build_step,
        sharded_morton_sort,
    )

    dev = resolve_device(device)
    mesh = _dryrun_mesh(n_devices, dev)

    # --- 1. the f32 stats step (the exact builder never takes it).
    n_small = n_devices * STATS_POINTS_PER_SHARD
    small = np.random.default_rng(7).random((n_small, 3),
                                            dtype=np.float32) * 100.0
    step = make_sharded_build_step(mesh, stats_level=3)
    result, total_nodes = step(small, np.zeros(3, np.float32),
                               np.float32(100.0))
    valid, dropped = sum(result.valid_count), sum(result.overflow)
    if valid + dropped != n_small or total_nodes <= 0:
        raise AssertionError(f"stats step: {valid} + {dropped} != {n_small}"
                             f" or {total_nodes} nodes")

    # --- 2. capacity overflow and retry on skewed data: 40% of the points
    # in one Morton slice, so the first (factor 1.0) attempt overflows.
    rng = np.random.default_rng(11)
    skew_pos = rng.random((SKEW_POINTS, 3)) * 100.0
    skew_pos[: int(SKEW_POINTS * 0.4)] *= 0.01  # dense knot at the origin
    skew_pos = skew_pos[rng.permutation(SKEW_POINTS)]  # on every shard
    cells = morton.quantize(skew_pos, np.zeros(3), 100.0, morton.MAX_DEPTH)
    stats: dict = {}
    codes, order = sharded_morton_sort(cells, mesh, morton.MAX_DEPTH,
                                       capacity_factor=1.0, stats=stats)
    host_codes = morton.morton_encode(cells)
    host_order = np.argsort(host_codes, kind="stable")
    if not ((codes == host_codes[host_order]).all()
            and (order == host_order).all()):
        raise AssertionError("sharded sort differs from the host sort")
    if n_devices > 1 and stats["attempts"] < 2:
        raise AssertionError(f"expected an overflow retry, got {stats}")

    # --- 3. the full distributed build (color + intensity) of an Earth-
    # surface cloud, half in 8 dense clusters, against one device.
    n = BUILD_POINTS
    rng = np.random.default_rng(23)
    half = n // 2
    local = np.empty((n, 3), dtype=np.float64)
    local[:half] = rng.random((half, 3)) * 100.0
    centers = rng.random((8, 3)) * 90.0 + 5.0
    for i in range(8):
        lo = half + (n - half) * i // 8
        hi = half + (n - half) * (i + 1) // 8
        local[lo:hi] = centers[i] + rng.normal(0.0, 0.05, (hi - lo, 3))
    frame = local_frame_from_lat_lng(37.4, -122.1)  # ECEF -> ENU
    positions = frame.inverse().transform_points(local - 50.0)
    idx_arr = np.arange(n, dtype=np.uint32)
    index_color = np.stack(
        [(idx_arr >> 16) & 0xFF, (idx_arr >> 8) & 0xFF, idx_arr & 0xFF],
        axis=1,
    ).astype(np.uint8)
    batch = PointsBatch(positions, attributes={
        "color": index_color,
        "intensity": rng.random(n).astype(np.float32),
    })
    base = tempfile.mkdtemp(prefix="dryrun_multichip_")
    try:
        mesh_dir = os.path.join(base, "mesh")
        single_dir = os.path.join(base, "single")
        t0 = time.perf_counter()
        mesh_result = build_octree(mesh_dir, 0.001, batch, mesh=mesh)
        t_mesh = time.perf_counter() - t0
        t0 = time.perf_counter()
        build_octree(single_dir, 0.001, batch, device=dev)
        t_single = time.perf_counter() - t0
        n_files = _dirs_byte_equal(mesh_dir, single_dir)
        # --- 4. geodesic queries over the mesh-built cloud.
        query_counts = _geodesic_query_check(mesh_dir, single_dir, positions,
                                             dev)
    finally:
        shutil.rmtree(base, ignore_errors=True)

    shard_counts = mesh_result.shard_points
    if shard_counts is None or sum(shard_counts) != n:
        raise AssertionError(f"shard points {shard_counts} do not sum to {n}")
    summary = {
        "n_devices": n_devices, "mesh": [str(d) for d in mesh],
        "stats_valid": valid, "stats_dropped": dropped,
        "stats_nodes": total_nodes, "skew_attempts": stats["attempts"],
        "skew_final_factor": stats["final_factor"], "points": n,
        "files": n_files, "mesh_s": t_mesh, "single_s": t_single,
        "shard_points": list(shard_counts),
        "cell_union_points": query_counts[0],
        "web_mercator_points": query_counts[1],
    }
    print(
        f"dryrun_multichip({n_devices}) on {summary['mesh']}: stats step "
        f"exchanged {valid}/{n_small} ({dropped} dropped, {total_nodes} "
        f"level-3 nodes); skewed sort retried {stats['attempts'] - 1}x to "
        f"factor {stats['final_factor']:.1f}; distributed build of {n} ECEF "
        f"points (color+intensity) byte-identical to one device across "
        f"{n_files} files, mesh {t_mesh:.3f} s vs single {t_single:.3f} s, "
        f"points a shard {list(shard_counts)}; geodesic queries over the "
        f"mesh-built cloud: cell union {query_counts[0]} points, Web "
        f"Mercator rect {query_counts[1]} points, equal to the single-"
        f"device cloud's and to brute force within the quantization "
        f"envelope", flush=True)
    return summary


def _geodesic_query_check(mesh_dir: str, single_dir: str, ecef: np.ndarray,
                          device) -> tuple:
    """__graft_entry__.py:257-319: an S2 cell-union and a Web Mercator rect
    query streamed over the mesh-built and the single-device octrees (the
    client's filter on `device`): per query the two index sets (decoded
    from the index-in-color encoding) must be identical and within the
    quantization envelope of brute-force membership over the raw positions
    (point_cloud_test/tests/main.rs:199-202).  -> (union_count, rect_count)
    from the mesh-built cloud."""
    from .math import s2
    from .math.web_mercator import WebMercatorRect, lat_lng_to_web_mercator
    from .math.wgs84 import ecef_to_geodetic
    from .query.client import PointCloudClient
    from .query.point_query import PointQuery
    from .s2_cells.cell_union import CellUnion

    leaves = s2.leaf_cell_ids_from_points(ecef[:512])
    union = CellUnion(np.unique(s2.parent(leaves, 20)))
    lat, lng, _ = ecef_to_geodetic(ecef.mean(axis=0))
    zoom = 18
    zoomed = lat_lng_to_web_mercator(lat, lng) * (256 << zoom)
    rect = WebMercatorRect.from_zoomed_coordinates(zoomed - 2.0,
                                                   zoomed + 2.0, zoom)
    if rect is None:
        raise AssertionError("degenerate Web Mercator rect")

    def stream_indices(directory, location):
        client = PointCloudClient.from_locations([directory], device=device)
        batches = []
        client.for_each_point_data(
            PointQuery(attributes=["color"], location=location),
            batches.append)
        got = []
        for b in batches:
            c = b.attributes["color"].astype(np.uint32)
            got.append((c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2])
        return np.sort(np.concatenate(got)) if got else np.empty(0, np.uint32)

    counts = []
    for location in (union, rect):
        got_mesh = stream_indices(mesh_dir, location)
        got_single = stream_indices(single_dir, location)
        if not np.array_equal(got_mesh, got_single):
            raise AssertionError("mesh-built and single-device query sets "
                                 "differ")
        expected = np.nonzero(location.contains(ecef))[0]
        if len(expected) == 0:
            raise AssertionError("degenerate geodesic query fixture")
        sym = (np.setdiff1d(got_mesh, expected).size
               + np.setdiff1d(expected, got_mesh).size)
        denom = max(len(got_mesh), len(expected), 1)
        if sym > max(2, denom // 100):
            raise AssertionError(f"geodesic query off brute force by {sym} "
                                 f"of {denom}")
        counts.append(int(len(got_mesh)))
    return tuple(counts)
