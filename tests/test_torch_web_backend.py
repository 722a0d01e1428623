"""The port's two web servers (viewer/web_backend.py, xray/backend.py) and
their CLIs against the JAX package's: both octree servers on port 0 over
the same octree answer /init_tree, /, /visible_nodes for seeded camera
matrices and /nodes_data of each visible list byte for byte alike, and
/visible_nodes equals Octree.visible_node_names_json; their 400, 404 and
500 answers match; the blob decodes per the module docstring's layout;
loads are single-flight; both x-ray servers over one quadtree built by the
port give the same /meta and /nodes_for_level bytes and every tile's file
bytes, and 404/400/301 alike; the CLIs parse their arguments as the JAX
ones.  Tolerance 0 everywhere (the replies are bytes), except decoded
positions, which lie within their node cube (1e-9 m of slack for the
f64 arithmetic of the decode, as tests/test_web_backend.py)."""

import json
import os
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from point_cloud_viewer_tpu.viewer import web_backend as JW
from point_cloud_viewer_tpu.xray import backend as JX
from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
from point_cloud_viewer_tpu_torch.math.geometry import (
    Frustum, Isometry, Perspective)
from point_cloud_viewer_tpu_torch.octree.builder import build_octree
from point_cloud_viewer_tpu_torch.octree.node_id import NodeId
from point_cloud_viewer_tpu_torch.octree.octree import Octree, _node_names_json
from point_cloud_viewer_tpu_torch.viewer import web_backend as PW
from point_cloud_viewer_tpu_torch.xray import backend as PX


def _request(url, body=None):
    """(status, content type, body) of one request, error answers too."""
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _serve(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """tests/test_web_backend.py's cloud (50,000 points in a 20 m box,
    colour and intensity) built by the port under <root>/mycloud, served by
    the port's and the JAX package's AppState on port 0."""
    rng = np.random.default_rng(5)
    n = 50_000
    root = tmp_path_factory.mktemp("trees")
    out = str(root / "mycloud")
    build_octree(out, 0.001, PointsBatch(
        position=rng.random((n, 3)) * 20.0,
        attributes={"color": rng.integers(0, 256, (n, 3), dtype=np.uint8),
                    "intensity": rng.random(n).astype(np.float32)}),
        device="cpu")
    running = [M.make_server(M.AppState(prefix=str(root),
                                        init_octree_id="mycloud"),
                             ip="127.0.0.1", port=0) for M in (PW, JW)]
    yield [_serve(s) for s in running], out
    for s in running:
        s.shutdown()
        s.server_close()


def _both(bases, path, body=None):
    got = [_request(base + path, body) for base in bases]
    assert got[0] == got[1], path
    return got[0]


@pytest.mark.parametrize("path,code", [("/init_tree", 200), ("/", 200),
                                       ("/index.html", 200),
                                       ("/nosuch", 404),
                                       ("/visible_nodes/a/b/c", 404)])
def test_get_replies_byte_equal(servers, path, code):
    status, _, body = _both(servers[0], path)
    assert status == code
    if path == "/init_tree":
        assert body == b"mycloud"
    if path == "/":
        assert b"<canvas" in body and b"visible_nodes" in body


def _matrices(octree, count=8):
    """Seeded camera matrices: `count` orbit views around the cloud at
    seeded distances and heights, and tests/test_web_backend.py's frustum."""
    rng = np.random.default_rng(31)
    center = octree.bounding_box.center()
    diag = float(np.linalg.norm(octree.bounding_box.diag()))
    out = []
    for k in range(count):
        angle = 2 * np.pi * k / count
        eye = center + diag * rng.uniform(0.4, 1.5) * np.array(
            [np.cos(angle), np.sin(angle), rng.uniform(0.1, 0.8)])
        iso = Isometry.from_axis_angle([0, 0, 1], angle + np.pi / 2,
                                       translation=eye)
        iso = Isometry(iso.rotation @ Isometry.from_axis_angle(
            [1, 0, 0], np.pi / 3).rotation, eye)
        out.append(Frustum.new(iso, Perspective.from_fov(
            1.3, 0.9, 0.1, 10 * diag)).clip_from_query)
    eye = Isometry.from_axis_angle([1, 0, 0], 0.0,
                                   translation=[10.0, 10.0, 90.0])
    out.append(Frustum.new(eye, Perspective.from_fov(1.0, 1.2, 0.5, 300.0)
                           ).clip_from_query)
    return out


def _matrix_param(m):
    return ",".join(repr(float(v)) for v in np.asarray(m).T.reshape(-1))


@pytest.mark.parametrize("k", range(9))
def test_visible_nodes_and_nodes_data_byte_equal(servers, k):
    bases, out = servers
    octree = Octree.from_directory(out)
    matrix = _matrices(octree)[k]
    status, ctype, body = _both(
        bases, f"/visible_nodes/mycloud/?matrix={_matrix_param(matrix)}")
    assert (status, ctype) == (200, "application/json")
    # The server decodes the column-major text; repr round-trips exactly.
    assert body == octree.visible_node_names_json(matrix)
    names = json.loads(body)
    assert names == [str(n) for n in octree.get_visible_nodes(matrix)]
    assert names, "every seeded view sees part of the cloud"
    status, ctype, blob = _both(bases, "/nodes_data/mycloud/",
                                json.dumps(names).encode())
    assert (status, ctype) == (200, "application/octet-stream")
    assert blob == PW.build_nodes_data_blob(octree, names)
    _check_blob(octree, names, blob)


def _check_blob(octree, names, blob):
    """The layout of web_backend's docstring: per node f64 min xyz, f64
    edge, u32 count, u8 bytes a coordinate, pad, positions, pad, rgb, pad;
    counts equal the metas, positions inside the node cube."""
    off = 0
    for name in names:
        meta = octree.node_meta(NodeId.from_str(name))
        minx, miny, minz, edge = struct.unpack_from("<dddd", blob, off)
        assert [minx, miny, minz] == list(meta.cube_min)
        assert edge == meta.edge_length
        num_points, bpc = struct.unpack_from("<IB", blob, off + 32)
        assert num_points == meta.num_points
        assert bpc == meta.position_encoding.bytes_per_coordinate
        off = (off + 37 + 7) & ~7
        dtype = {1: "<u1", 2: "<u2", 4: "<f4", 8: "<f8"}[bpc]
        t = np.frombuffer(blob, dtype, count=num_points * 3, offset=off)
        scale = {1: 255.0, 2: 65535.0}.get(bpc, 1.0)
        pos = (t.astype(np.float64) / scale).reshape(-1, 3) * edge + [
            minx, miny, minz]
        assert (pos >= meta.cube_min - 1e-9).all()
        assert (pos <= meta.cube_min + edge + 1e-9).all()
        off = (off + num_points * 3 * bpc + 7) & ~7
        off = (off + num_points * 3 + 7) & ~7
    assert off == len(blob)


@pytest.mark.parametrize("case", ["bad_matrix", "unknown_tree",
                                  "post_unknown_path", "post_unknown_tree",
                                  "post_bad_json", "post_bad_name"])
def test_error_answers_match_jax(servers, case):
    ones = ",".join(["1.0"] * 16)
    path, body, code = {
        "bad_matrix": ("/visible_nodes/mycloud/?matrix=1,2,3", None, 400),
        "unknown_tree": (f"/visible_nodes/nosuch/?matrix={ones}", None, 404),
        "post_unknown_path": ("/nodes_data/", b"[]", 404),
        "post_unknown_tree": ("/nodes_data/nosuch/", b'["r"]', 500),
        "post_bad_json": ("/nodes_data/mycloud/", b"[r", 500),
        "post_bad_name": ("/nodes_data/mycloud/", b'["x1"]', 500),
    }[case]
    status, _, _ = _both(servers[0], path, body)
    assert status == code


def test_batched_posts_of_every_node(servers):
    """The client's fetch discipline (<= 50 nodes a POST, 3 at a time):
    every node of the tree round-trips, each batch's blob as the JAX
    server's."""
    from concurrent.futures import ThreadPoolExecutor

    bases, out = servers
    names = [str(n) for n in Octree.from_directory(out).node_ids]
    batches = [names[i:i + 50] for i in range(0, len(names), 50)]
    with ThreadPoolExecutor(max_workers=3) as pool:
        blobs = list(pool.map(
            lambda b: _both(bases, "/nodes_data/mycloud/",
                            json.dumps(b).encode())[2], batches))
    assert len(blobs) == len(batches) and all(blobs)


def test_load_octree_single_flight(servers, monkeypatch):
    """Concurrent first requests for one uncached id load it once; a failing
    load wedges no later caller."""
    _, out = servers
    state = PW.AppState(prefix=os.path.dirname(out))
    loads = []
    real = Octree.from_directory.__func__

    def slow(cls, d):
        loads.append(d)
        time.sleep(0.2)
        return real(cls, d)

    monkeypatch.setattr(Octree, "from_directory", classmethod(slow))
    got = []
    threads = [threading.Thread(
        target=lambda: got.append(state.load_octree("mycloud")))
        for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(loads) == 1
    assert len(got) == 6 and all(o is got[0] for o in got)
    for _ in range(2):
        with pytest.raises(FileNotFoundError):
            state.load_octree("nosuch")
    assert not state._loading


def test_float64_wire_decode_preserves_resolution(tmp_path):
    """A FLOAT64-encoded node through the port's server decodes to the
    advertised resolution by the client's recipe, as the JAX test holds the
    JAX server; the blob equals the JAX server's."""
    rng = np.random.default_rng(8)
    n, res = 4000, 1e-7
    root = tmp_path / "trees"
    root.mkdir()
    out = str(root / "f64cloud")
    build_octree(out, res, PointsBatch(
        position=np.array([1e7, 2e7, 3e7]) + rng.random((n, 3)) * 20.0,
        attributes={"color": rng.integers(0, 256, (n, 3), dtype=np.uint8)}),
        device="cpu")
    octree = Octree.from_directory(out)
    assert octree.node_meta(NodeId.from_str("r")
                            ).position_encoding.bytes_per_coordinate == 8
    running = [M.make_server(M.AppState(prefix=str(root)), port=0)
               for M in (PW, JW)]
    try:
        bases = [_serve(s) for s in running]
        _, _, blob = _both(bases, "/nodes_data/f64cloud/", b'["r"]')
    finally:
        for s in running:
            s.shutdown()
            s.server_close()
    minx, miny, minz, edge = struct.unpack_from("<dddd", blob, 0)
    num_points, _ = struct.unpack_from("<IB", blob, 32)
    t = np.frombuffer(blob, "<f8", count=num_points * 3, offset=40
                      ).reshape(-1, 3)
    offset = np.array([minx, miny, minz]) + edge / 2
    truth = octree.points_in_node(NodeId.from_str("r"), attributes=["color"])
    dec = t * edge + [minx, miny, minz] - offset
    assert np.abs(dec - (truth.position - offset)).max() <= res


def test_node_names_json_matches_jax_full_level_range():
    """The /visible_nodes serializer over levels 0..40 (paths across the
    lo/hi u64 boundary), permuted, and empty: the JAX package's bytes."""
    from point_cloud_viewer_tpu.octree.octree import _node_names_json as jax_f

    rng = np.random.default_rng(11)
    levels, his, los, expected = [], [], [], []
    for level in list(range(0, 41)) + [21, 22, 40]:
        path = 0
        for _ in range(level):
            path = (path << 3) | int(rng.integers(0, 8))
        levels.append(level)
        his.append(path >> 64)
        los.append(path & ((1 << 64) - 1))
        expected.append("r" + (format(path, "o").zfill(level) if level
                               else ""))
    args = (np.array(levels, np.uint8), np.array(his, np.uint64),
            np.array(los, np.uint64))
    order = rng.permutation(len(levels))
    got = _node_names_json(*args, order)
    assert got == jax_f(*args, order)
    assert json.loads(got) == [expected[i] for i in order]
    empty = np.array([], dtype=np.int64)
    assert _node_names_json(*args, empty) == jax_f(*args, empty) == b"[]"


# -- the x-ray server ----------------------------------------------------------


@pytest.fixture(scope="module")
def xray_servers(tmp_path_factory):
    """tests/test_web_backend.py's x-ray build (20,000 points, 64 px tiles
    of 0.05 m) over a 12 m x 12 m box, so 16 leaf tiles at level 2, made by
    the port on the CPU, served by both packages' x-ray servers on port 0
    and under a prefix."""
    from point_cloud_viewer_tpu_torch.query.client import PointCloudClient
    from point_cloud_viewer_tpu_torch.xray.build import (
        XrayParameters, build_xray_quadtree)

    rng = np.random.default_rng(6)
    tmp = tmp_path_factory.mktemp("xray")
    cloud = str(tmp / "cloud")
    build_octree(cloud, 0.001, PointsBatch(
        position=rng.random((20_000, 3)) * [12.0, 12.0, 3.0],
        attributes={"color": rng.integers(0, 256, (20_000, 3),
                                          dtype=np.uint8)}), device="cpu")
    xdir = str(tmp / "xray")
    build_xray_quadtree("xray", XrayParameters(
        xdir, PointCloudClient.from_locations([cloud], num_threads=1,
                                              device="cpu"),
        tile_size_px=64, pixel_size_m=0.05),
        strategy_kwargs={"device": "cpu"}, num_threads=2)
    running = [PX.make_server(xdir, port=0), JX.make_server(xdir, port=0),
               PX.make_server(xdir, port=0, prefix="/x"),
               JX.make_server(xdir, port=0, prefix="/x")]
    yield [_serve(s) for s in running], xdir
    for s in running:
        s.shutdown()
        s.server_close()


_IDENTITY = ",".join(map(str, [1e-2, 0, 0, 0, 0, 1e-2, 0, 0, 0, 0, 1e-2, 0,
                               0, 0, 0, 1]))


@pytest.mark.parametrize("path,code", [
    ("/meta", 200), ("/", 200), ("/nosuch", 404),
    (f"/nodes_for_level?level=0&matrix={_IDENTITY}", 200),
    (f"/nodes_for_level?level=1&matrix={_IDENTITY}", 200),
    (f"/nodes_for_level?level=x&matrix={_IDENTITY}", 400),
    ("/nodes_for_level?level=0", 404),
    ("/node_image/r9", 404), ("/node_image/../meta.pb", 404),
])
def test_xray_replies_byte_equal(xray_servers, path, code):
    bases, xdir = xray_servers
    status, _, body = _both(bases[:2], path)
    assert status == code
    assert _both(bases[2:], "/x" + path) == (status, _, body)
    if path == "/meta":
        meta = json.loads(body)
        assert meta["tile_size"] == 64 and "bounding_rect" in meta
    if path.startswith("/nodes_for_level?level=0&"):
        assert json.loads(body)[0]["id"] == "r"


def test_xray_tiles_equal_their_files(xray_servers):
    bases, xdir = xray_servers
    tiles = sorted(f[:-4] for f in os.listdir(xdir) if f.endswith(".png"))
    assert len(tiles) == 21  # 16 leaves, 4 parents, the root
    for tile in tiles:
        status, ctype, body = _both(bases[:2], f"/node_image/{tile}")
        assert (status, ctype) == (200, "image/png")
        with open(os.path.join(xdir, tile + ".png"), "rb") as f:
            assert body == f.read()
    redirect = [urllib.request.Request(b + "/x", method="GET")
                for b in bases[2:]]
    for req in redirect:  # the prefix without its slash: 301 to "/x/"
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.geturl().endswith("/x/") and r.status == 200


# -- the CLIs -----------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["{tree}"], ["{tree}/", "--port", "6001", "--ip", "0.0.0.0"],
    ["--prefix", "{root}", "--init_id", "mycloud", "--suffix", "s"],
    ["--prefix", "{root}"], [],
])
def test_points_web_viewer_cli_matches_jax(servers, argv, monkeypatch,
                                           capsys):
    from point_cloud_viewer_tpu.cli import points_web_viewer as jcli
    from point_cloud_viewer_tpu_torch.cli import points_web_viewer as cli

    _, tree = servers
    argv = [a.format(tree=tree, root=os.path.dirname(tree)) for a in argv]
    got = []
    for module, W in ((cli, PW), (jcli, JW)):
        calls = []
        monkeypatch.setattr(W, "serve_forever", lambda state, ip, port:
                            calls.append((vars(state)["prefix"],
                                          state.suffix, state.init_octree_id,
                                          ip, port)))
        try:
            rc = module.main(argv)
        except SystemExit as e:
            rc = ("exit", e.code)
        got.append((rc, calls, capsys.readouterr().err.replace(
            "point_cloud_viewer_tpu_torch", "point_cloud_viewer_tpu")))
    assert got[0][:2] == got[1][:2]
    assert got[0][0] == (0 if argv and argv[-1] != os.path.dirname(tree)
                         else ("exit", 2))


@pytest.mark.parametrize("argv", [["{x}"], ["{x}", "--port", "7", "--ip",
                                            "0.0.0.0"], []])
def test_xray_web_viewer_cli_matches_jax(xray_servers, argv, monkeypatch,
                                         capsys):
    from point_cloud_viewer_tpu.cli import xray_web_viewer as jcli
    from point_cloud_viewer_tpu_torch.cli import xray_web_viewer as cli

    _, xdir = xray_servers
    argv = [a.format(x=xdir) for a in argv]
    got = []
    for module, X in ((cli, PX), (jcli, JX)):
        calls = []
        monkeypatch.setattr(X, "serve_forever", lambda d, ip, port:
                            calls.append((d, ip, port)))
        try:
            rc = module.main(argv)
        except SystemExit as e:
            rc = ("exit", e.code)
        got.append((rc, calls))
        capsys.readouterr()
    assert got[0] == got[1]
    assert got[0][0] == (0 if argv else ("exit", 2))
