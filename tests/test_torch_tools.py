"""The port's host tools against the JAX package's, on seeded inputs: the S2
splitter and cli.build_s2 byte for byte (tests/golden/s2 too), the PLY
writers, cli.export_ply on the CPU route and the host route, cli.
upgrade_octree on v9, v11, v12 and v13 metas, node_ids_bfs, the provider
factory with a live HTTP provider, the colour helpers, every CLI's --help,
and octree and S2 clouds that the port built answering the same
index-coloured queries (the twin of tests/test_equivalence.py)."""

import contextlib
import functools
import io
import os
import threading

import numpy as np
import pytest

from point_cloud_viewer_tpu.core.points_batch import PointsBatch as JBatch
from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
from tests.conftest import assert_dirs_byte_equal

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(batch):
    """(port batch, JAX batch) over the same arrays."""
    return (PointsBatch(position=batch.position, attributes=batch.attributes),
            JBatch(position=batch.position, attributes=batch.attributes))


def _index_color(n):
    idx = np.arange(n, dtype=np.uint32)
    return np.stack([(idx >> 16) & 0xFF, (idx >> 8) & 0xFF, idx & 0xFF],
                    axis=1).astype(np.uint8)


def _indices(batches):
    out = []
    for b in batches:
        c = b.attributes["color"].astype(np.uint32)
        out.append((c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2])
    return np.sort(np.concatenate(out)) if out else np.array([], np.uint32)


def _site(n, seed, lat, lng, extent):
    """n ECEF points over an extent x extent x 30 m site: index colour and
    intensity."""
    from point_cloud_viewer_tpu_torch.math.wgs84 import local_frame_from_lat_lng

    rng = np.random.default_rng(seed)
    local = (rng.random((n, 3)) - 0.5) * np.array([extent, extent, 30.0])
    ecef = local_frame_from_lat_lng(lat, lng).inverse().transform_points(local)
    return PointsBatch(position=ecef, attributes={
        "color": _index_color(n),
        "intensity": rng.random(n).astype(np.float32)})


def _run(main, args):
    """A CLI's main(args) -> its standard output (rc 0 required)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(args) == 0
    return buf.getvalue()


# --- the splitter ------------------------------------------------------------


def test_splitter_matches_golden_and_jax(tmp_path):
    """Twin of tests/test_golden.py::test_s2_format_is_stable: the port's
    build_s2_cloud on the golden seeded batch is byte-equal to tests/golden/s2
    and to the JAX splitter's directory, and returns the same meta."""
    from point_cloud_viewer_tpu.s2_cells.splitter import build_s2_cloud as jax_s2
    from point_cloud_viewer_tpu_torch.math.wgs84 import local_frame_from_lat_lng
    from point_cloud_viewer_tpu_torch.s2_cells.splitter import build_s2_cloud

    rng = np.random.default_rng(20260816)  # tests/test_golden.py:15-30
    n = 3000
    local = (rng.random((n, 3)) - 0.5) * np.array([50.0, 50.0, 10.0])
    ecef = local_frame_from_lat_lng(48.1374, 11.5755).inverse() \
        .transform_points(local)
    port, jax = _both(PointsBatch(position=ecef, attributes={
        "color": rng.integers(0, 255, (n, 3), dtype=np.uint8),
        "intensity": rng.random(n).astype(np.float32)}))
    mine = build_s2_cloud(str(tmp_path / "port"), port)
    theirs = jax_s2(str(tmp_path / "jax"), jax)
    assert mine.encode() == theirs.encode()
    assert_dirs_byte_equal(os.path.join(GOLDEN, "s2"), str(tmp_path / "port"),
                           context="golden")
    assert_dirs_byte_equal(str(tmp_path / "jax"), str(tmp_path / "port"),
                           context="port vs JAX")


def test_splitter_writer_cache_is_byte_transparent(tmp_path):
    """Twin of tests/test_s2.py::test_splitter_writer_cache_is_byte_
    transparent: caps 0, 1 and the default give the same bytes over
    multi-batch appends, equal to the JAX splitter's, with every writer
    closed after finish."""
    from point_cloud_viewer_tpu.s2_cells.splitter import S2Splitter as JSplitter
    from point_cloud_viewer_tpu_torch.math.wgs84 import local_frame_from_lat_lng
    from point_cloud_viewer_tpu_torch.s2_cells.splitter import S2Splitter

    rng = np.random.default_rng(7)
    frame = local_frame_from_lat_lng(12.3, 45.6)
    data = []
    for _ in range(4):
        local = (rng.random((400, 3)) - 0.5) * np.array([800.0, 800.0, 20.0])
        data.append(PointsBatch(
            position=frame.inverse().transform_points(local),
            attributes={"color": rng.integers(0, 255, (400, 3),
                                              dtype=np.uint8)}))
    for cap in (0, 1, 4096):
        sp = S2Splitter(str(tmp_path / f"cap{cap}"), max_open_writers=cap)
        for b in data:
            sp.write(b)
        sp.finish()
        assert sp._writers == {}
    jsp = JSplitter(str(tmp_path / "jax"))
    for b in data:
        jsp.write(_both(b)[1])
    jsp.finish()
    assert len(os.listdir(tmp_path / "cap0")) > 3
    for other in ("cap1", "cap4096", "jax"):
        assert_dirs_byte_equal(str(tmp_path / "cap0"), str(tmp_path / other),
                               context=other)


@pytest.mark.parametrize("case", ["not_ecef", "schema"])
def test_splitter_rejects_like_jax(tmp_path, case):
    """A point off the Earth's radius band and a batch whose attribute
    schema differs from the first raise ValueError with the JAX message."""
    from point_cloud_viewer_tpu.s2_cells.splitter import S2Splitter as JSplitter
    from point_cloud_viewer_tpu_torch.s2_cells.splitter import S2Splitter

    good = _site(50, 3, 10.0, 20.0, 100.0)
    if case == "not_ecef":
        bad = PointsBatch(position=good.position * 0.5,
                          attributes=good.attributes)
    else:
        bad = PointsBatch(position=good.position,
                          attributes={"color": good.attributes["color"]})
    errors = []
    for name, make, wrap in (("port", S2Splitter, lambda b: b),
                             ("jax", JSplitter, lambda b: _both(b)[1])):
        sp = make(str(tmp_path / name))
        if case == "schema":
            sp.write(wrap(good))
        with pytest.raises(ValueError) as e:
            sp.write(wrap(bad))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_build_s2_cli_matches_jax(tmp_path):
    """cli.build_s2 on a PLY that the port's write_ply made: the same cells
    and bytes as the JAX CLI, and the same summary line."""
    from point_cloud_viewer_tpu.cli import build_s2 as jax_cli
    from point_cloud_viewer_tpu_torch.cli import build_s2 as port_cli
    from point_cloud_viewer_tpu_torch.io.ply import write_ply

    ply = str(tmp_path / "site.ply")
    write_ply(ply, _site(30_000, 5, 47.0, 8.0, 2000.0))
    said = []
    for name, cli in (("port", port_cli), ("jax", jax_cli)):
        out = str(tmp_path / name)
        said.append(_run(cli.main, [ply, "--output_directory", out,
                                    "--split_level", "16"]).replace(out, "D"))
    assert said[0] == said[1] and "30000 points" in said[0]
    assert_dirs_byte_equal(str(tmp_path / "jax"), str(tmp_path / "port"),
                           context="build_s2")


# --- PLY writers and the export CLI --------------------------------------------


@pytest.mark.parametrize("case", ["write_ply", "write_ply_offset", "stream",
                                  "stream_append"])
def test_ply_writers_match_jax(tmp_path, case):
    """write_ply and PlyStreamWriter (fresh, appended, a schema mismatch)
    write the JAX package's bytes, and the port's reader reads them back."""
    from point_cloud_viewer_tpu.io import ply as J
    from point_cloud_viewer_tpu_torch.io import ply as P

    rng = np.random.default_rng(11)
    batches = [PointsBatch(position=rng.random((n, 3)) * 100.0, attributes={
        "color": rng.integers(0, 256, (n, 3), dtype=np.uint8),
        "intensity": rng.random(n).astype(np.float32),
        "ts": rng.random(n)}) for n in (1000, 1, 2500)]
    offset = np.array([1.5, -2.0, 3.25]) if case.endswith("offset") else None
    for name, M in (("port", P), ("jax", J)):
        path = str(tmp_path / f"{name}.ply")
        mine = [b if M is P else _both(b)[1] for b in batches]
        if case.startswith("write_ply"):
            M.write_ply(path, mine[0], offset=offset)
            continue
        with M.PlyStreamWriter(path) as w:
            for b in mine[:2]:
                w.write(b)
        if case == "stream_append":
            with M.PlyStreamWriter(path, append=True) as w:
                w.write(mine[2])
                with pytest.raises(ValueError):
                    w.write(type(mine[2])(position=mine[2].position))
    with open(tmp_path / "port.ply", "rb") as f, \
            open(tmp_path / "jax.ply", "rb") as g:
        assert f.read() == g.read()
    back = P.PlyReader(str(tmp_path / "port.ply")).read_all()
    want = PointsBatch.concatenate(
        batches[:1] if case.startswith("write_ply") else
        batches if case == "stream_append" else batches[:2])
    position = (want.position if offset is None
                else (want.position - offset) + offset)
    np.testing.assert_array_equal(back.position, position)
    np.testing.assert_array_equal(back.attributes["color"],
                                  want.attributes["color"])


@pytest.fixture(scope="module")
def earth(tmp_path_factory):
    """60,000 index-coloured ECEF points over a 300 m site; the port builds
    an octree (CPU route, 1 cm) and an S2 cloud (level 20) of them."""
    from point_cloud_viewer_tpu_torch.octree.builder import build_octree
    from point_cloud_viewer_tpu_torch.s2_cells.splitter import build_s2_cloud

    batch = _site(60_000, 4711, 37.4, -122.1, 300.0)
    octree = str(tmp_path_factory.mktemp("octree"))
    s2dir = str(tmp_path_factory.mktemp("s2"))
    build_octree(octree, 0.01, batch, device="cpu")
    build_s2_cloud(s2dir, batch, split_level=20)
    return batch, octree, s2dir


def _sorted_rows(path):
    from point_cloud_viewer_tpu_torch.io.ply import PlyReader

    batch = PlyReader(path).read_all()
    order = np.lexsort(batch.position.T)
    return len(batch), b"".join(
        [batch.position[order].tobytes()]
        + [batch.attributes[k][order].tobytes() for k in sorted(
            batch.attributes)])


@pytest.mark.parametrize("source", ["octree", "s2"])
@pytest.mark.parametrize("route", ["cpu", "host"])
def test_export_ply_matches_jax(tmp_path, earth, source, route):
    """cli.export_ply of an AABB with an intensity interval, the filter on
    CPU tensors (--device cpu) or on the host (--no-device_filter): its
    sorted rows equal the JAX CLI's export of the same cloud; --append
    doubles the vertex count."""
    from point_cloud_viewer_tpu.cli import export_ply as jax_cli
    from point_cloud_viewer_tpu_torch.cli import export_ply as port_cli
    from point_cloud_viewer_tpu_torch.io.ply import PlyReader

    batch, octree, s2dir = earth
    directory = octree if source == "octree" else s2dir
    center = batch.position.mean(axis=0)
    box = ",".join(repr(float(v)) for v in (*(center - 70.0),
                                            *(center + 50.0)))
    args = [f"--aabb={box}", "--attributes", "color", "intensity",
            "--filter_interval", "intensity=0.2,0.6"]
    flags = ["--device", "cpu"] if route == "cpu" else ["--no-device_filter"]
    mine, theirs = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    said = _run(port_cli.main, [directory, "--output", mine, *args, *flags])
    _run(jax_cli.main, [directory, "--output", theirs, *args])
    got, want = _sorted_rows(mine), _sorted_rows(theirs)
    assert got == want and got[0] > 100
    assert said == f"Wrote {got[0]} points to {mine}\n"
    _run(port_cli.main, [directory, "--output", mine, *args, *flags,
                         "--append"])
    assert PlyReader(mine).num_points == 2 * got[0]


def test_export_ply_on_the_card_by_default(tmp_path, earth):
    """Without a card, the port's export raises before it writes a file
    (the JAX CLI's host default is --no-device_filter here)."""
    import torch

    from point_cloud_viewer_tpu_torch.cli import export_ply

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default route runs there")
    out = tmp_path / "x.ply"
    with pytest.raises(RuntimeError, match="cuda"):
        export_ply.main([earth[1], "--output", str(out)])
    assert not out.exists()


# --- upgrade, traversal, providers, colour, --help --------------------------------


def _meta(version):
    """An octree meta.pb at `version`, built at the wire level as
    tests/test_meta_migrations.py builds them."""
    from point_cloud_viewer_tpu_torch.protos import pbwire as pb

    def vec(xyz):
        w = pb.FieldWriter()
        for i, v in enumerate(xyz, 1):
            w.double(i, v)
        return w.finish()

    def node(value, count):
        nid = pb.FieldWriter()
        if version == 9:
            nid.varint(1, value >> 120, signed=True)
            nid.varint(2, value & ((1 << 120) - 1), signed=True)
        else:
            nid.varint(3, value >> 64)
            nid.varint(4, value & ((1 << 64) - 1))
        w = pb.FieldWriter()
        w.varint(2, 2)
        w.varint(3, count, signed=True)
        w.message(4, nid.finish())
        return w.finish()

    nodes = [node(0, 100), node((1 << 120) | 3, 42), node((2 << 120) | 0o45, 7)]
    bbox = pb.FieldWriter()
    bbox.message(3, vec((-1.0, -2.0, -3.0)))
    bbox.message(4, vec((4.0, 5.0, 6.0)))
    meta = pb.FieldWriter()
    meta.varint(1, version, signed=True)
    if version in (9, 11):
        meta.double(3, 0.05)
        meta.message(4, bbox.finish())
        for n in nodes:
            meta.message(5, n)
    else:
        octree = pb.FieldWriter()
        if version == 12:
            octree.message(1, bbox.finish())
        octree.double(2, 0.05)
        for n in nodes:
            octree.message(3, n)
        if version == 13:
            meta.message(4, bbox.finish())
        meta.message(6, octree.finish())
    return meta.finish()


@pytest.mark.parametrize("version", [9, 11, 12, 13])
def test_upgrade_octree_matches_jax(tmp_path, version):
    """cli.upgrade_octree rewrites a v9, v11 or v12 meta.pb to the JAX
    CLI's bytes (and leaves a v13 one alone), printing the same line
    (tests/test_meta_migrations.py:113)."""
    from point_cloud_viewer_tpu.cli import upgrade_octree as jax_cli
    from point_cloud_viewer_tpu_torch.cli import upgrade_octree as port_cli
    from point_cloud_viewer_tpu_torch.protos.meta import MetaProto

    raw = _meta(version)
    out, said = [], []
    for name, cli in (("port", port_cli), ("jax", jax_cli)):
        d = tmp_path / name
        d.mkdir()
        (d / "meta.pb").write_bytes(raw)
        said.append(_run(cli.main, [str(d)]).replace(str(d), "D"))
        out.append((d / "meta.pb").read_bytes())
    assert out[0] == out[1] and said[0] == said[1]
    meta = MetaProto.decode(out[0])
    assert meta.version == 13 and len(meta.octree.nodes) == 3
    assert (out[0] == raw) == (version == 13)


@pytest.fixture(scope="module")
def octree_dir(tmp_path_factory):
    """tests/test_utils_io.py's cloud, cut to 60,000 points, built by the
    port's CPU route."""
    from point_cloud_viewer_tpu_torch.octree.builder import build_octree

    rng = np.random.default_rng(3)
    batch = PointsBatch(position=rng.random((60_000, 3)) * 10.0, attributes={
        "color": rng.integers(0, 255, (60_000, 3), dtype=np.uint8)})
    out = str(tmp_path_factory.mktemp("oct"))
    build_octree(out, 0.001, batch, device="cpu")
    return out


@pytest.mark.parametrize("predicate", ["all", "level<=1", "root"])
def test_node_ids_bfs_matches_jax(octree_dir, predicate):
    """node_ids_bfs yields the JAX order (tests/test_utils_io.py:65)."""
    from point_cloud_viewer_tpu.octree.octree import Octree as JOctree
    from point_cloud_viewer_tpu.octree.traversal import node_ids_bfs as jax_bfs
    from point_cloud_viewer_tpu_torch.octree.node_id import NodeId
    from point_cloud_viewer_tpu_torch.octree.octree import Octree
    from point_cloud_viewer_tpu_torch.octree.traversal import node_ids_bfs

    keep = {"all": lambda n: True, "level<=1": lambda n: n.level <= 1,
            "root": lambda n: n.level == 0}[predicate]
    mine = [str(n) for n in node_ids_bfs(Octree.from_directory(octree_dir),
                                         keep)]
    theirs = [str(n) for n in jax_bfs(JOctree.from_directory(octree_dir),
                                      keep)]
    assert mine == theirs and mine[0] == str(NodeId.root())
    if predicate == "all":
        assert len(mine) == len(Octree.from_directory(octree_dir)) > 1
    assert NodeId.root().child(5).child(2) == NodeId.from_str("r52")


def _provider_case_factory(octree_dir):
    from point_cloud_viewer_tpu_torch.io.factory import (
        DataProviderFactory, HttpDataProvider, default_factory)
    from point_cloud_viewer_tpu_torch.io.node_io import (
        DataProvider, OnDiskDataProvider)

    f = default_factory()
    assert type(f.generate_data_provider(octree_dir)) is OnDiskDataProvider
    for url in ("http://example.com/tree/", "https://example.com/tree"):
        p = f.generate_data_provider(url)
        assert isinstance(p, HttpDataProvider) and isinstance(p, DataProvider)
        assert p.base_url == url.rstrip("/")
    made = []
    custom = DataProviderFactory().register("mem://", made.append)
    assert custom.generate_data_provider("mem://x") is None
    assert made == ["mem://x"]
    base = DataProvider()
    assert base.meta_bytes() is None
    with pytest.raises(NotImplementedError):
        base.meta_proto()


def _provider_case_http(octree_dir):
    """Both packages' HTTP providers over a live server of the directory:
    the same meta bytes and root node, NodeNotFound for a missing node."""
    from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

    from point_cloud_viewer_tpu.io.factory import default_factory as jax_factory
    from point_cloud_viewer_tpu.octree.octree import Octree as JOctree
    from point_cloud_viewer_tpu_torch.io.factory import default_factory
    from point_cloud_viewer_tpu_torch.io.node_io import NodeNotFound
    from point_cloud_viewer_tpu_torch.octree.node_id import NodeId
    from point_cloud_viewer_tpu_torch.octree.octree import Octree

    class Quiet(SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), functools.partial(
        Quiet, directory=octree_dir))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        provider = default_factory().generate_data_provider(url)
        with open(os.path.join(octree_dir, "meta.pb"), "rb") as f:
            assert provider.meta_bytes() == f.read()
        mine = Octree(provider).points_in_node(NodeId.root(), ["color"])
        theirs = JOctree(jax_factory().generate_data_provider(url)) \
            .points_in_node(type(JOctree.from_directory(octree_dir)
                                 .node_ids[0]).root(), ["color"])
        assert len(mine) > 0
        np.testing.assert_array_equal(mine.position, theirs.position)
        np.testing.assert_array_equal(mine.attributes["color"],
                                      theirs.attributes["color"])
        with pytest.raises(NodeNotFound):
            provider.data("r777777", ["color"])
    finally:
        server.shutdown()
        server.server_close()


def _provider_case_color(octree_dir):
    from point_cloud_viewer_tpu.core import color as J
    from point_cloud_viewer_tpu_torch.core import color as P

    rng = np.random.default_rng(2)
    f = np.concatenate([rng.random(1000) * 1.4 - 0.2, [0.5, 1.0, 0.0, 1.0]])
    u8 = rng.integers(0, 256, 1000).astype(np.uint8)
    np.testing.assert_array_equal(P.to_u8(f), J.to_u8(f))
    np.testing.assert_array_equal(P.to_f32(u8), J.to_f32(u8))
    np.testing.assert_array_equal(P.to_u8(f[-4:]), [127, 255, 0, 255])
    for name in ("WHITE", "BLACK", "RED", "GREEN", "BLUE", "TRANSPARENT"):
        np.testing.assert_array_equal(getattr(P, name), getattr(J, name))


@pytest.mark.parametrize("case", ["factory", "http", "color"])
def test_providers_and_color_match_jax(octree_dir, case):
    """tests/test_utils_io.py:37-105's factory, live HTTP provider and
    colour helpers, held to the JAX package's."""
    globals()[f"_provider_case_{case}"](octree_dir)


_CLIS = ["build_octree", "build_s2", "build_xray_quadtree", "export_ply",
         "inpaint_xray_quadtree", "merge_xray_quadtrees", "points_web_viewer",
         "query_points", "upgrade_octree", "upgrade_xray_quadtree", "view",
         "xray_web_viewer"]


@pytest.mark.parametrize("name", _CLIS)
def test_every_cli_parses_help(name):
    """Each of the port's 12 CLIs imports and answers --help (the twin of
    tests/test_utils_io.py::test_every_cli_parses_help)."""
    import importlib

    mod = importlib.import_module(f"point_cloud_viewer_tpu_torch.cli.{name}")
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(SystemExit) as e:
            mod.main(["--help"])
    assert e.value.code == 0


# --- octree and S2 agree ----------------------------------------------------------


def _location(kind, ecef):
    from point_cloud_viewer_tpu_torch.math import s2
    from point_cloud_viewer_tpu_torch.math.geometry import (
        Aabb, Frustum, Isometry, Obb, Perspective)
    from point_cloud_viewer_tpu_torch.math.web_mercator import (
        WebMercatorRect, lat_lng_to_web_mercator)
    from point_cloud_viewer_tpu_torch.math.wgs84 import ecef_to_geodetic
    from point_cloud_viewer_tpu_torch.query.location import AllPoints
    from point_cloud_viewer_tpu_torch.s2_cells.cell_union import CellUnion

    center = ecef.mean(axis=0)
    if kind == "all":
        return AllPoints()
    if kind == "aabb":
        return Aabb(center - 60.0, center + 60.0)
    if kind == "obb":
        return Obb(Isometry.from_axis_angle([0.3, 0.8, 0.51], 0.9,
                                            translation=center),
                   [80.0, 50.0, 20.0])
    if kind == "frustum":
        up = center / np.linalg.norm(center)
        x = np.cross([0.0, 0.0, 1.0], up)
        x /= np.linalg.norm(x)
        rot = np.stack([x, np.cross(up, x), up], axis=1)
        return Frustum.new(Isometry(rot, center + up * 200.0),
                           Perspective.from_fov(1.0, 1.0, 10.0, 400.0))
    if kind == "cell_union":
        leaves = s2.leaf_cell_ids_from_points(ecef[:1000])
        return CellUnion(np.unique(s2.parent(leaves, 18)))
    lat, lng, _ = ecef_to_geodetic(center)
    z = 18
    zoomed = lat_lng_to_web_mercator(lat, lng) * (256 << z)
    # +-40 px at zoom 18 (tests/test_equivalence.py's +-2 px over 1M
    # points holds a few points of 60,000)
    return WebMercatorRect.from_zoomed_coordinates(zoomed - 40.0,
                                                   zoomed + 40.0, z)


@pytest.mark.parametrize("kind", ["all", "aabb", "obb", "frustum",
                                  "cell_union", "web_mercator"])
def test_octree_and_s2_agree(earth, kind):
    """The port's octree and S2 cloud of the same index-coloured points,
    queried through the port's client with the filter on CPU tensors:
    all points equal, each geometry's sets within the quantisation
    allowance of tests/test_equivalence.py, the S2 set exactly the
    geometry's own on the unquantised points; each equals the host
    route's."""
    from point_cloud_viewer_tpu_torch.query.client import PointCloudClient
    from point_cloud_viewer_tpu_torch.query.point_query import PointQuery

    batch, octree, s2dir = earth
    location = _location(kind, batch.position)
    got = []
    for d in (octree, s2dir):
        per_route = []
        for kwargs in ({"device": "cpu"}, {"device_filter": False}):
            client = PointCloudClient.from_locations([d], num_threads=2,
                                                     **kwargs)
            per_route.append(_indices(list(client.stream(PointQuery(
                attributes=["color"], location=location)))))
        np.testing.assert_array_equal(per_route[0], per_route[1])
        got.append(per_route[0])
    a, b = got
    if kind == "all":
        np.testing.assert_array_equal(a, b)
        assert len(a) == len(batch)
        return
    assert len(a) > 0
    sym = np.setdiff1d(a, b).size + np.setdiff1d(b, a).size
    assert sym <= max(2, max(len(a), len(b)) // 100), sym
    np.testing.assert_array_equal(
        b, np.nonzero(location.contains(batch.position))[0])
