"""The viewer's node selection over a city's ECEF node table, on the CPU
route: the benchmark's generator of node tables (benchmark/generators/
city_table.py) at a small size, the cull session in the frame of an f64
origin with the cap applied on the device, judged against the plain
reference (benchmark/reference/cull.py) in f64 in the ECEF frame by the
`flyover` traffic's judge; a session without an origin keeps its bits; the
f32 world frame fails the judge; the viewer's visible list on a TLS-like
table is what it was; and the spans and counters of the capped path
record only under a profiler."""

import gc
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

# The benchmark's modules import each other by their bare names.  At the
# end of the path, so that `tests` stays this folder for every test file
# that runs after this one in the same process.
BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

import harness  # noqa: E402
from point_cloud_viewer_tpu_torch.octree.octree import Octree  # noqa: E402
from point_cloud_viewer_tpu_torch.ops.culling import (  # noqa: E402
    DeviceCullSession, Frustum, frustum_cull_lod_select, pad_cull_axes)
from point_cloud_viewer_tpu_torch.utils import progress  # noqa: E402
from point_cloud_viewer_tpu_torch.viewer.render_loop import (  # noqa: E402
    PointCloudRenderer, collector_paused, cull_session, node_id_list)

SAMPLE = 400_000  # about 20k nodes
CAP = 600
SEED = 2**31 + 4099


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _small_config():
    """The city configuration with the sample cut to SAMPLE points and the
    points it stands for cut alike, so the leaf threshold is the same."""
    cfg = harness.config("city_1m_nodes")
    g = cfg["generator_params"]
    return dict(cfg, num_points=cfg["num_points"] * SAMPLE // g["sample_points"],
                generator_params=dict(g, sample_points=SAMPLE))


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    """The flyover traffic's state at a small size: the generator's table
    written and opened, the viewer's session on the CPU, the flight."""
    flyover = harness.load_module("traffic", "flyover")
    cell = harness.cell("city_1m_nodes.select")
    cell["params"] = dict(cell["params"], node_cap=CAP, frames=12,
                          compare_frames=4)
    cfg = _small_config()
    out = str(tmp_path_factory.mktemp("city") / "octree")
    tree = harness.load_module("generators", "city_table").generate(
        cfg, SEED, out)
    octree = Octree.from_directory(out)
    return dict(cell=cell, config=cfg, tree=tree, octree=octree,
                matrices=flyover.flight(cfg["generator_params"],
                                        cell["params"]),
                flyover=flyover)


def _judged(city, session):
    """The judge's numbers of `session`'s capped lists over the flight's
    frames, and whether each is within the cell's limit."""
    got = {}
    for f in range(0, len(city["matrices"]), 3):
        order, sizes, seen = session.step_capped(
            Frustum.from_matrix4(city["matrices"][f]), CAP)
        assert seen > CAP  # the cap binds in every frame
        ids = node_id_list(city["octree"], order)
        got[f] = ([(n.level, n.index) for n in ids], sizes)
    r = city["flyover"].judge(city, got)
    limits = city["cell"]["limits"]
    return r, {k: r[k] <= limits[k] for k in limits}


def test_generator_table_is_a_tree(city):
    tree, octree = city["tree"], city["octree"]
    assert 15_000 < len(tree.counts) < 40_000
    keys = set(zip(tree.levels.tolist(), tree.paths.tolist()))
    parents = {(lv - 1, p >> 3) for lv, p in keys if lv}
    assert parents <= keys
    assert (tree.counts > 0).all()
    children = {(lv, p) for lv, p in parents}
    leaf = np.array([k not in children for k in zip(tree.levels.tolist(),
                                                    tree.paths.tolist())])
    assert (tree.leaf_points[leaf] > 0).all()
    assert (tree.leaf_points[~leaf] == 0).all()
    assert (tree.leaf_points[leaf & (tree.levels < tree.depth)]
            <= tree.threshold).all()
    assert tree.leaf_points.sum() == SAMPLE
    # The meta.pb the program reads back: ids, counts and cubes.
    np.testing.assert_array_equal(octree.levels, tree.levels)
    np.testing.assert_array_equal(octree.num_points, tree.counts)
    np.testing.assert_allclose(octree.cube_mins, tree.node_min, rtol=0,
                               atol=1e-8)
    np.testing.assert_array_equal(octree.cube_edges, tree.node_edge)
    assert [(n.level, n.index) for n in (octree.node_ids[i] for i in
                                         range(0, len(octree), 997))] == [
        (int(tree.levels[i]), int(tree.paths[i]))
        for i in range(0, len(octree), 997)]


def test_session_with_origin_meets_the_reference_in_ecef(city):
    session = cull_session(city["octree"], "cpu")
    np.testing.assert_array_equal(session.origin,
                                  city["octree"].root_cube.center())
    r, within = _judged(city, session)
    assert all(within.values()), r
    assert r["node_set_gap"] == 0


def test_world_frame_f32_fails_the_judge(city):
    """A session without an origin over ECEF (f32 world coordinates, the
    session's arithmetic before the origin) and the reference in f32 in
    the ECEF frame (the cell's control) both come out not correct."""
    octree = city["octree"]
    world = DeviceCullSession(octree.cube_mins, octree.cube_edges,
                              octree.num_points, device="cpu")
    r, within = _judged(city, world)
    assert not all(within.values()), r
    state = dict(city, sample=set(range(0, len(city["matrices"]), 3)))
    r = city["flyover"].control(state)
    limits = city["cell"]["limits"]
    assert not all(r[k] <= limits[k] for k in limits), r


@pytest.mark.parametrize("cap", [0, 1, CAP, 10**9])
@pytest.mark.parametrize("local", [True, False], ids=["origin", "world"])
def test_capped_list_is_the_uncapped_prefix(city, cap, local):
    octree = city["octree"]
    session = DeviceCullSession(
        octree.cube_mins, octree.cube_edges, octree.num_points, device="cpu",
        origin=octree.root_cube.center() if local else None)
    for matrix in city["matrices"][::4]:
        frustum = Frustum.from_matrix4(matrix)
        order, sizes, visible = session.step(frustum)
        got, got_sizes, seen = session.step_capped(frustum, cap)
        n = min(int(visible.sum()), cap)
        assert seen == int(visible.sum())
        assert got.dtype == np.int32 and got_sizes.dtype == np.float32
        np.testing.assert_array_equal(got, order[:n])
        np.testing.assert_array_equal(got_sizes.view(np.int32),
                                      sizes[order[:n]].view(np.int32))


def _old_step(frustum, mins, edges, num_points):
    """The session's step as it was before the origin: the projections and
    the matrix cut to f32 in the world frame."""
    cached = frustum.intersector().cached_axes_for_aabb()
    proj = cached.corners @ cached.axes.T
    axes, qn, qx = pad_cull_axes(cached.axes.astype(np.float32),
                                 proj.min(axis=0).astype(np.float32),
                                 proj.max(axis=0).astype(np.float32), 32)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    order, sizes, visible = frustum_cull_lod_select(
        t(frustum.clip_from_query.astype(np.float32)), t(axes), t(qn), t(qx),
        torch.as_tensor(np.asarray(mins, np.float32)),
        torch.as_tensor(np.asarray(edges, np.float32)),
        torch.as_tensor(np.asarray(num_points, np.int32)))
    return order.numpy(), sizes.numpy(), visible.numpy()


@pytest.mark.parametrize("origin", [None, (0.0, 0.0, 0.0)],
                         ids=["none", "zero"])
def test_no_origin_keeps_the_bits(city, origin):
    octree = city["octree"]
    session = DeviceCullSession(octree.cube_mins, octree.cube_edges,
                                octree.num_points, device="cpu",
                                origin=origin)
    for matrix in city["matrices"][::3]:
        frustum = Frustum.from_matrix4(matrix)
        for got, want in zip(session.step(frustum), _old_step(
                frustum, octree.cube_mins, octree.cube_edges,
                octree.num_points)):
            np.testing.assert_array_equal(got.view(np.uint8),
                                          want.view(np.uint8))
        for got, want in zip(session.step_frames([frustum]),
                             _old_step(frustum, octree.cube_mins,
                                       octree.cube_edges, octree.num_points)):
            np.testing.assert_array_equal(got[0].view(np.uint8),
                                          want.view(np.uint8))


@pytest.fixture(scope="module")
def tls_like(tmp_path_factory):
    """A TLS-like octree at 1 mm: the scan generator's layout (200 x 200 x
    40 m, half in 64 clusters of sigma 0.5 m), tabled by the city
    generator's rule at a threshold of 20 points: 13,701 nodes."""
    gen = harness.load_module("generators", "city_table")
    ref_octree = gen.ref_octree
    scan = harness.config("tls_scan_16m")
    cloud = harness.load_module("generators", "tls_scan").generate(
        dict(scan, num_points=60_000), SEED)
    cfg = {"generator_params": {"sample_points": 60_000}, "num_points": 60_000,
           "max_points_per_node": 20, "resolution": 0.001}
    tree = gen.table(cfg, SEED, sample=gen.codes(cloud["position"], 0.001))
    out = tmp_path_factory.mktemp("tls_like")
    (out / "meta.pb").write_bytes(ref_octree.meta_bytes(tree, 0.001))
    return Octree.from_directory(str(out)), cloud["position"]


@pytest.mark.parametrize("max_nodes", [None, 50, 100_000])
def test_viewer_visible_list_is_unchanged_on_a_tls_like_table(tls_like,
                                                              max_nodes):
    """The renderer's capped step in the root cube's frame against the
    list its uncapped step in the world frame gave, capped on the host:
    the same length, the same screen sizes position by position, and the
    same nodes, up to screen-size near-ties (RTOL, ATOL of
    tests/test_torch_cull.py, by which the session's order has always met
    the JAX session's): an f32 size a node gets in one frame may differ in
    its last bits in the other and swap it with an equal neighbour."""
    rtol, atol = 1e-5, 1e-6
    octree, pos = tls_like
    assert len(octree) > 10_000
    select = harness.load_module("traffic", "select")
    renderer = PointCloudRenderer(octree, width=800, height=600,
                                  device_cull=True, device="cpu")
    try:
        if max_nodes is not None:
            renderer.node_views.max_nodes = max_nodes
        cap = renderer.node_views.max_nodes
        world = DeviceCullSession(octree.cube_mins, octree.cube_edges,
                                  octree.num_points, device="cpu")
        row = {octree.node_ids[i].value: i for i in range(len(octree))}
        for matrix in select.orbit(pos.min(0), pos.max(0), 8, 800, 600, 0.3):
            frustum = Frustum.from_matrix4(matrix)
            order, sizes, visible = world.step(frustum)
            want = order[:min(int(visible.sum()), cap)]
            got = np.array([row[n.value]
                            for n in renderer._device_visible(frustum)])
            assert len(got) == len(want) > 0
            np.testing.assert_allclose(sizes[got], sizes[want], rtol=rtol,
                                       atol=atol)
            apart = np.setxor1d(got, want)
            np.testing.assert_allclose(sizes[apart], sizes[want[-1]],
                                       rtol=rtol, atol=atol)
            if len(want) < int(visible.sum()):
                continue
            assert len(apart) == 0  # uncapped: the same nodes
    finally:
        renderer.shutdown()


NAMES = ("select.ids", "select.visible", "select.fetch_bytes")


def test_city_spans_and_counters_record_only_under_a_profiler(city):
    session = cull_session(city["octree"], "cpu")
    frustum = Frustum.from_matrix4(city["matrices"][0])
    progress.reset_span_totals()
    try:
        node_id_list(city["octree"],
                     session.step_capped(frustum, CAP)[0])
        assert not set(NAMES) & set(progress.span_totals())
        with profile(activities=[ProfilerActivity.CPU]):
            order, _, seen = session.step_capped(frustum, CAP)
            node_id_list(city["octree"], order)
            session.step(frustum)
        totals = progress.span_totals()
        assert totals["select.ids"][0] == 1 and totals["select.ids"][1] > 0
        assert totals["select.visible"] == [seen, 0.0]
        k = len(city["octree"])
        assert totals["select.fetch_bytes"] == [(2 * CAP + 1) * 4 + 9 * k,
                                                0.0]
        assert all(totals[s][0] == 2 for s in (
            "select.prep", "select.upload", "select.launch", "select.fetch"))
    finally:
        progress.reset_span_totals()


@pytest.mark.parametrize("rows", ["strided", "reversed", "none"])
def test_node_id_list_gives_the_rows_ids_in_order(city, rows):
    octree = city["octree"]
    idx = {"strided": np.arange(0, len(octree), 2)[:10_000],
           "reversed": np.arange(len(octree))[::-1][:CAP],
           "none": np.arange(0)}[rows]
    ids = node_id_list(octree, idx)
    assert ids == [octree.node_ids[i] for i in idx]
    assert [(n.level, n.index) for n in ids] == [
        (int(city["tree"].levels[i]), int(city["tree"].paths[i]))
        for i in idx]


@pytest.mark.parametrize("enabled", [True, False])
def test_node_id_list_runs_no_collection_and_restores_the_collector(
        city, enabled):
    """10,000 NodeIds would set off ~14 young collections with the
    collector running; the list runs none while it is built (one young
    collection may follow once the collector is back), and leaves the
    collector as it found it."""
    octree = city["octree"]
    rows = np.arange(0, len(octree), 2)[:10_000]
    started = []

    def seen(phase, info):
        if phase == "start":
            started.append(info["generation"])

    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    gc.callbacks.append(seen)
    try:
        ids = node_id_list(octree, rows)
        during = list(started)
        after = gc.isenabled()
    finally:
        gc.callbacks.remove(seen)
        (gc.enable if was else gc.disable)()
    assert len(ids) == len(rows)
    assert len(during) <= (1 if enabled else 0), during
    assert after is enabled


def test_collector_pauses_overlap_across_threads():
    """The first of two overlapping pauses disables the collector, and it
    comes back only when the last one ends, whichever thread holds it."""
    entered, release = threading.Event(), threading.Event()
    states = []

    def second():
        with collector_paused():
            entered.set()
            release.wait(10)
            states.append(gc.isenabled())

    was = gc.isenabled()
    gc.enable()
    try:
        with collector_paused():
            states.append(gc.isenabled())
            t = threading.Thread(target=second)
            t.start()
            assert entered.wait(10)
        states.append(gc.isenabled())  # the second pause still holds
        release.set()
        t.join(10)
        states.append(gc.isenabled())
    finally:
        (gc.enable if was else gc.disable)()
    assert states == [False, False, False, True]


@pytest.mark.parametrize("side", ["within", "past"])
def test_tie_at_the_cap_is_as_wide_as_its_limit(city, side):
    """The capped list of a frame with its cap-th node swapped for the
    first smaller visible node past the cap: excused where the cap's
    width reaches that node, counted, and read in `cap_gap`, where it
    does not."""
    flyover, tree = city["flyover"], city["tree"]
    res = float(city["config"]["resolution"])
    order, sizes, visible, margin = flyover.reference(
        tree, city["matrices"][0], "float64", 4096)
    last = sizes[order[CAP - 1]]
    nxt = next(k for k in order[CAP:int(visible.sum())]
               if sizes[k] < last and abs(margin[k]) > res)
    depth = (last - sizes[nxt]) / last
    width = depth * (1.01 if side == "within" else 0.99)
    limits = dict(city["cell"]["limits"], cap_gap=width)
    state = dict(city, cell=dict(city["cell"], limits=limits))
    rows = np.concatenate([order[:CAP - 1], [nxt]])
    keys = [(int(tree.levels[k]), int(tree.paths[k])) for k in rows]
    r = flyover.judge(state, {0: (keys, sizes[rows])})
    assert r["cap_gap"] == pytest.approx(depth)
    assert r["node_set_gap"] == (0 if side == "within" else 1)
    assert (r["cap_gap"] <= width) == (side == "within")
