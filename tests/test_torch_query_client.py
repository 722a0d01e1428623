"""The port's query client and CLI (query/client.py, cli/query_points.py)
over an octree and an S2 cloud that the JAX package built, against the
JAX package's client and CLI: the same points (sorted positions and
colours, byte for byte) and the same counts, with the filter on CPU
tensors (`device="cpu"`) and on the host (`device_filter=False`); and the
client semantics of tests/test_client.py (exact batches, early
termination, cancellation, the fully-inside shortcut)."""

import re
import threading

import numpy as np
import pytest

import point_cloud_viewer_tpu.math.geometry as JG
import point_cloud_viewer_tpu.math.web_mercator as JWM
import point_cloud_viewer_tpu_torch.math.geometry as PG
import point_cloud_viewer_tpu_torch.math.web_mercator as PWM
from point_cloud_viewer_tpu.cli import query_points as jax_cli
from point_cloud_viewer_tpu.core.points_batch import PointsBatch as JBatch
from point_cloud_viewer_tpu.math import s2 as JS2
from point_cloud_viewer_tpu.math.intervals import ClosedInterval as JInterval
from point_cloud_viewer_tpu.math.wgs84 import local_frame_from_lat_lng
from point_cloud_viewer_tpu.octree.builder import build_octree as jax_build
from point_cloud_viewer_tpu.query.client import PointCloudClient as JClient
from point_cloud_viewer_tpu.query.point_query import PointQuery as JQuery
from point_cloud_viewer_tpu.s2_cells.cell_union import CellUnion as JUnion
from point_cloud_viewer_tpu.s2_cells.splitter import build_s2_cloud
from point_cloud_viewer_tpu_torch.cli import query_points as port_cli
from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
from point_cloud_viewer_tpu_torch.math.intervals import ClosedInterval
from point_cloud_viewer_tpu_torch.query.client import PointCloudClient
from point_cloud_viewer_tpu_torch.query.location import location_for
from point_cloud_viewer_tpu_torch.query.point_query import PointQuery
from point_cloud_viewer_tpu_torch.s2_cells.cell_union import CellUnion

LAT, LON = 12.3, 45.6
SITE = np.array([400.0, 400.0, 30.0])  # metres, local east/north/up


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def site(tmp_path_factory):
    """120,000 ECEF points over a 400 x 400 x 30 m site (half uniform, half
    in 8 Gaussian clusters), colour and intensity; the JAX package builds
    an octree (1 mm) and an S2 cloud of them."""
    rng = np.random.default_rng(42)
    n = 120_000
    local = (rng.random((n, 3)) - 0.5) * SITE
    centers = (rng.random((8, 3)) - 0.5) * SITE
    local[n // 2:] = (centers[rng.integers(0, 8, n - n // 2)]
                      + rng.normal(0.0, 6.0, (n - n // 2, 3)))
    frame = local_frame_from_lat_lng(LAT, LON)
    ecef = frame.inverse().transform_points(local)
    batch = JBatch(position=ecef, attributes={
        "color": rng.integers(0, 256, (n, 3), dtype=np.uint8),
        "intensity": rng.random(n).astype(np.float32)})
    octree = str(tmp_path_factory.mktemp("octree"))
    s2dir = str(tmp_path_factory.mktemp("s2"))
    jax_build(octree, 0.001, batch)
    build_s2_cloud(s2dir, batch)
    return {"batch": batch, "frame": frame, "octree": octree, "s2": s2dir}


def _site_geometry(G, WM, kind, frame, ecef):
    """A query over part of the site, built by either package's modules."""
    center = frame.inverse().transform_points(np.zeros((1, 3)))[0]
    to_ecef = G.Isometry(frame.inverse().rotation, frame.inverse().translation)
    if kind == "aabb":
        return G.Aabb(center - [90.0, 120.0, 60.0], center + [110.0, 70.0, 80.0])
    if kind == "obb":
        pose = to_ecef.compose(G.Isometry.from_axis_angle(
            [0, 0, 1], 0.3, translation=[20.0, -30.0, 0.0]))
        return G.Obb(pose, np.array([100.0, 60.0, 10.0]))
    if kind == "frustum":
        eye = to_ecef.compose(G.Isometry.from_axis_angle(
            [1, 0, 0], 0.2, translation=[-40.0, 10.0, 300.0]))
        return G.Frustum.new(eye, G.Perspective.from_fov(1.3, 0.6, 1.0, 400.0))
    if kind == "cell_union":
        ids = [int(c) for c in JS2.parent(
            JS2.leaf_cell_ids_from_points(ecef[::4000]), 16)]
        return (CellUnion if G is PG else JUnion)(ids)
    lat, lon = np.deg2rad([LAT - 0.0007, LAT + 0.0011]), np.deg2rad(
        [LON - 0.0009, LON + 0.0006])
    nw = WM.lat_lng_to_web_mercator(lat[1], lon[0])
    se = WM.lat_lng_to_web_mercator(lat[0], lon[1])
    return WM.WebMercatorRect(WM.WebMercatorCoord(nw), WM.WebMercatorCoord(se))


QUERIES = ["all", "aabb", "obb", "frustum", "cell_union", "web_mercator",
           "obb+intensity"]


def _queries(site, kind):
    """(port PointQuery, JAX PointQuery) of a kind."""
    geometry = kind.split("+")[0]
    intervals = "+intensity" in kind
    args = [], []
    for G, WM, Q, I, out in ((PG, PWM, PointQuery, ClosedInterval, args[0]),
                             (JG, JWM, JQuery, JInterval, args[1])):
        loc = (None if geometry == "all" else _site_geometry(
            G, WM, geometry, site["frame"], site["batch"].position))
        out.append(Q(attributes=["color", "intensity"], location=loc,
                      filter_intervals=({"intensity": I(0.25, 0.75)}
                                        if intervals else {})))
    return args[0][0], args[1][0]


def _collect(client, query):
    got = list(client.stream(query))
    if not got:
        return np.empty((0, 3)), np.empty((0, 3), np.uint8)
    pos = np.concatenate([b.position for b in got])
    col = np.concatenate([b.attributes["color"] for b in got])
    order = np.lexsort(pos.T)
    return pos[order], col[order]


@pytest.mark.parametrize("container", ["octree", "s2"])
@pytest.mark.parametrize("kind", QUERIES)
def test_client_streams_the_jax_clients_points(site, container, kind):
    port_q, jax_q = _queries(site, kind)
    want = _collect(JClient.from_locations([site[container]], num_threads=2),
                    jax_q)
    assert 0 < len(want[0]) < len(site["batch"]) or kind == "all"
    for kwargs in ({"device": "cpu"}, {"device_filter": False}):
        client = PointCloudClient.from_locations(
            [site[container]], num_threads=2, **kwargs)
        got = _collect(client, port_q)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes(), (kind, kwargs)
        if kwargs.get("device") == "cpu" and kind != "all" and not (
                container == "s2" and kind == "cell_union"):
            # (the union holds every storage cell it meets: all skip it)
            assert client.filter_stats.rows > 0


def _said(main, argv, capsys) -> int:
    assert main(argv) == 0
    out = capsys.readouterr().out
    return int(re.search(r"Streamed (\d+) points", out).group(1))


def test_cli_counts_match_jax(site, capsys):
    """Each query flag of the CLI, on the port's filter (--device cpu) and
    on the host (--no-device_filter), against the JAX CLI, over the octree
    and the S2 cloud at once; --num_points stops early alike."""
    ecef = site["batch"].position
    union = _site_geometry(PG, PWM, "cell_union", site["frame"], ecef)
    rect = _site_geometry(PG, PWM, "web_mercator", site["frame"], ecef)
    zoom = 18
    nw = rect.north_west.to_zoomed_coordinate(zoom)
    se = rect.south_east.to_zoomed_coordinate(zoom)
    aabb = _site_geometry(PG, PWM, "aabb", site["frame"], ecef)
    flags = [
        [],
        ["--aabb", ",".join(repr(float(v)) for v in [*aabb.mins, *aabb.maxs])],
        ["--cell_union", ",".join(JS2.token(int(c)) for c in union.ids)],
        ["--web_mercator_rect",
         ",".join(repr(float(v)) for v in [*nw, *se]) + f",{zoom}"],
        ["--filter_interval", "intensity=0.25,0.75", "--attributes",
         "color", "intensity"],
        ["--num_points", "5000", "--batch_size", "1000"],
    ]
    dirs = [site["octree"], site["s2"]]
    for extra in flags:
        base = dirs + ["--num_threads", "2"] + extra
        want = _said(jax_cli.main, base, capsys)
        assert _said(port_cli.main, base + ["--device", "cpu"], capsys) == want
        assert _said(port_cli.main, base + ["--no-device_filter"],
                     capsys) == want
        if "--num_points" not in extra:
            assert 0 < want <= 2 * len(ecef), extra
        else:
            assert 5000 <= want < 2 * len(ecef)


def test_batches_are_exact(site):
    client = PointCloudClient.from_locations(
        [site["octree"]], batch_size=10_000, num_threads=4, device="cpu")
    sizes = []
    client.for_each_point_data(PointQuery(attributes=["color"]),
                               lambda b: sizes.append(len(b)))
    assert sum(sizes) == len(site["batch"])
    assert len(sizes) - sizes.count(10_000) <= 4


def test_early_termination_and_cancellation(site):
    """A callback's exception stops the stream after its call; an
    abandoned stream cancels and joins its workers; a stream after it
    still returns every point."""
    client = PointCloudClient.from_locations(
        [site["octree"]], batch_size=5_000, num_threads=4, device="cpu")
    query = PointQuery(attributes=["color"], location=_site_geometry(
        PG, PWM, "obb", site["frame"], site["batch"].position))
    calls = []

    class Boom(RuntimeError):
        pass

    def cb(batch):
        calls.append(len(batch))
        if len(calls) == 2:
            raise Boom("stop")

    with pytest.raises(Boom):
        client.for_each_point_data(query, cb)
    assert len(calls) == 2
    client = PointCloudClient.from_locations(
        [site["octree"]], batch_size=100, num_threads=2, device="cpu")
    gen = client.stream(PointQuery(attributes=["color"]))
    assert len(next(gen)) == 100
    gen.close()
    alive = [t for t in threading.enumerate()
             if t.name == "pcv-stream-worker" and t.is_alive()]
    assert not alive, alive
    assert sum(len(b) for b in client.stream(
        PointQuery(attributes=["color"]))) == len(site["batch"])


def test_filter_attribute_must_be_queried(site):
    client = PointCloudClient.from_locations([site["octree"]], num_threads=2,
                                             device="cpu")
    with pytest.raises(KeyError):
        client.for_each_point_data(PointQuery(
            attributes=["color"], location=_site_geometry(
                PG, PWM, "aabb", site["frame"], site["batch"].position),
            filter_intervals={"intensity": ClosedInterval(0, 1)}),
            lambda b: None)


def test_fully_inside_flags_match_jax(site):
    """nodes_in_location_ex: the same nodes and fully-inside flags as the
    JAX package, for a box around the root cube (every node flagged), a
    partial box, an OBB (never flagged) and, on the S2 cloud, a cell
    union (cells inside it flagged)."""
    from point_cloud_viewer_tpu.octree.octree import Octree as JOctree
    from point_cloud_viewer_tpu.query.location import location_for as jloc
    from point_cloud_viewer_tpu.s2_cells.container import S2Cells as JCells
    from point_cloud_viewer_tpu_torch.octree.octree import Octree
    from point_cloud_viewer_tpu_torch.s2_cells.container import S2Cells

    pos = site["batch"].position
    mine, theirs = (Octree.from_directory(site["octree"]),
                    JOctree.from_directory(site["octree"]))
    lo, hi = mine.root_cube.min - 1.0, mine.root_cube.max() + 1.0
    boxes = [(PG.Aabb(lo, hi), JG.Aabb(lo, hi))]
    boxes += [tuple(_site_geometry(G, WM, kind, site["frame"], pos)
                    for G, WM in ((PG, PWM), (JG, JWM)))
              for kind in ("aabb", "obb")]
    for i, (p, j) in enumerate(boxes):
        got = [(str(n), f) for n, f in mine.nodes_in_location_ex(
            location_for(p))]
        want = [(str(n), f) for n, f in theirs.nodes_in_location_ex(jloc(j))]
        assert got == want and got
        assert all(f for _, f in got) if i == 0 else True
    cells, jcells = (S2Cells.from_directory(site["s2"]),
                     JCells.from_directory(site["s2"]))
    union = _site_geometry(PG, PWM, "cell_union", site["frame"], pos)
    coarse = [int(c) for c in JS2.parent(cells.cell_ids[:40], 14)]
    for ids in (list(union.ids), coarse):
        got = [(str(c), f) for c, f in cells.nodes_in_location_ex(
            CellUnion(ids))]
        want = [(str(c), f) for c, f in jcells.nodes_in_location_ex(
            JUnion(ids))]
        assert got == want and got
    assert any(f for _, f in got)


def test_points_batch_retain_and_split_off():
    rng = np.random.default_rng(3)
    pos = rng.random((50, 3))
    attrs = {"v": np.arange(50, dtype=np.float32)}
    keep = rng.random(50) < 0.5
    for B in (PointsBatch, JBatch):
        kept = B(position=pos, attributes=attrs).retain(keep)
        batch = B(position=pos, attributes=attrs)
        tail = batch.split_off(20)
        assert kept.position.tobytes() == pos[keep].tobytes()
        assert (len(batch), len(tail)) == (20, 30)
        assert tail.attributes["v"].tobytes() == attrs["v"][20:].tobytes()
