"""The port's own copies of the JAX package's host modules (core, protos,
ops.codec, native, math, io, octree.node_id, octree.octree, viewer.camera,
the query path's and the x-ray path's) against the originals, on seeded
numpy inputs: every copied native function bit-equal, meta.pb bytes and
decoded fields equal, PLY batches equal, the octree's fields and visible
sets equal on a tree built by both packages, and the camera's matrices
equal; the x-ray copies marked unchanged are their originals' text, and
their wire format, quadtree algebra, colormaps, tile selection, extension
hooks and progress bar behave alike; the viewers' and web servers' copies
(camera, input, terrain, the GL modules, the servers) are their
originals' text, the shaders, both web clients and the SDL stub their
bytes, and the copies that differ (the GL viewer, the SDL shell, the web
viewer CLI) differ only where named; the public names added to trimmed
copies are their originals' text and behave alike.  One parametrised
test per module."""

import os

import numpy as np
import pytest

from point_cloud_viewer_tpu import native as jax_native
from point_cloud_viewer_tpu.octree.builder import build_octree as jax_build
from point_cloud_viewer_tpu.core.points_batch import PointsBatch as JaxBatch
from point_cloud_viewer_tpu_torch import native
from point_cloud_viewer_tpu_torch.octree.builder import build_octree

RNG_SEED = 20


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensor ops: one intra-op thread, so the test workers do not
    crowd each other's cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(a, b):
    """Equal arrays, dtypes and bits (NaN matching NaN)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _cull_args(k, seed, dtype):
    from point_cloud_viewer_tpu_torch.ops.culling import (
        Frustum, Isometry, Perspective, frustum_axes_and_projections)

    rng = np.random.default_rng(seed)
    frustum = Frustum.new(
        Isometry.from_axis_angle([0, 1, 0], 0.3, translation=[40., 40., 90.]),
        Perspective.from_fov(1.2, 1.0, 0.5, 300.0))
    axes, qmin, qmax = frustum_axes_and_projections(frustum)
    mins = rng.random((k, 3)) * 80.0
    edges = 80.0 / np.exp2(rng.integers(0, 7, k))
    num_points = rng.integers(0, 50, k).astype(np.int32)
    return [np.asarray(a, dtype=dtype) for a in
            (frustum.clip_from_query, axes, qmin, qmax, mins, edges)] + [
                num_points]


def _heap_args(seed):
    """A small complete tree (levels 0-3) in (level, path) order, as
    Octree._build_heap_index lays it out."""
    from point_cloud_viewer_tpu_torch.ops.culling import (
        Frustum, Isometry, Perspective, frustum_axes_and_projections)

    levels = np.concatenate([np.full(8 ** l, l) for l in range(4)])
    paths = np.concatenate([np.arange(8 ** l) for l in range(4)])
    edges = 64.0 / np.exp2(levels)
    mins = np.zeros((len(levels), 3))
    for d in range(1, 4):
        digit = (paths >> (3 * np.maximum(levels - d, 0))) & 7
        bits = np.stack([(digit >> 2) & 1, (digit >> 1) & 1, digit & 1], 1)
        mins += np.where((levels >= d)[:, None], bits * 64.0 / 2 ** d, 0.0)
    starts = np.concatenate([[0], np.cumsum([8 ** l for l in range(4)])])
    child_start = np.zeros(len(levels), np.int32)
    child_end = np.zeros(len(levels), np.int32)
    for l in range(3):
        a = np.arange(starts[l], starts[l + 1])
        child_start[a] = starts[l + 1] + 8 * (a - starts[l])
        child_end[a] = child_start[a] + 8
    frustum = Frustum.new(
        Isometry.from_axis_angle([1, 0, 0], 0.2, translation=[30., 20., 120.]),
        Perspective.from_fov(1.0, 0.8, 1.0, 500.0))
    axes, qmin, qmax = frustum_axes_and_projections(frustum)
    num_points = np.random.default_rng(seed).integers(
        0, 9, len(levels)).astype(np.int32)
    return (frustum.clip_from_query, axes.astype(np.float64),
            qmin.astype(np.float64), qmax.astype(np.float64), mins, edges,
            num_points, child_start, child_end, 0)


def _native_cases():
    rng = np.random.default_rng(RNG_SEED)
    n = 50_000
    pos = rng.random((n, 3)) * 100.0 - 20.0
    pos[:7] = [[np.nan, 0, 0], [np.inf, 1, 1], [-np.inf, 2, 2], [0, 0, 0],
               [80, 80, 80], [79.99999, 1e-12, 3], [-20, -20, -20]]
    cells = rng.integers(0, 2 ** 21, (n, 3)).astype(np.uint32)
    codes = np.sort(rng.integers(0, 2 ** 63, n, dtype=np.uint64))
    codes[100:5000] = codes[100]
    final = rng.integers(0, 9, n).astype(np.uint8)
    leaf = np.maximum(final, rng.integers(0, 9, n).astype(np.uint8))
    k = 300
    offsets = np.concatenate([[0], np.sort(rng.integers(0, n, k - 1)), [n]])
    idx = rng.permutation(n).astype(np.int64)
    node_min = rng.random((k, 3)) * 50.0
    node_edge = rng.random(k) * 60.0
    node_edge[:3] = 0.0
    ids = rng.integers(0, 64, n)
    u8 = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    u16 = rng.integers(0, 65536, (n, 3), dtype=np.uint16)
    pt_min = rng.random((n, 3)) * 10.0
    pt_edge = rng.random(n) * 5.0
    zero_edges = np.where(np.arange(n) % 97 == 0, 0.0, pt_edge)
    meta = _octree_meta_bytes(seed=RNG_SEED)
    cases = {
        "quantize_morton": lambda m: m.quantize_morton(
            pos, np.array([-20.0, -20.0, -20.0]), 100.0, 21, want_cells=True),
        "morton_encode": lambda m: m.morton_encode(cells),
        "radix_argsort_u64": lambda m: m.radix_argsort_u64(
            rng_codes(RNG_SEED)),
        "group_levels_full": lambda m: m.group_levels_full(
            codes, final, leaf, 21, 10),
        "counting_argsort": lambda m: m.counting_argsort(
            ids, np.bincount(ids, minlength=64)),
        "take_rows": lambda m: [m.take_rows(a, idx) for a in
                                (u8, u16, pos, final, pos[:, :1].copy())],
        "decode_positions": lambda m: [
            m.decode_positions(e, pt_min, pt_edge) for e in (u8, u16)],
        # Per-point and broadcast cubes, zero edges, NaN and +-inf
        # positions; a dtype other than u8/u16 gives None.
        "encode_positions_u8": lambda m: [
            m.encode_positions(pos, pt_min, zero_edges, np.uint8),
            m.encode_positions(pos, np.array([-20.0, -20.0, -20.0]), 100.0,
                               np.uint8)],
        "encode_positions_u16": lambda m: [
            m.encode_positions(pos, pt_min, zero_edges, np.uint16),
            m.encode_positions(pos, np.array([-20.0, -20.0, -20.0]), 100.0,
                               np.uint16),
            m.encode_positions(pos, pt_min, pt_edge, np.float32)],
        "cull_lod_select": lambda m: [
            m.cull_lod_select(*_cull_args(4000, RNG_SEED, dt), dtype=dt,
                              max_out=mo)
            for dt in (np.float32, np.float64) for mo in (0, 100)],
        "cull_lod_heap": lambda m: m.cull_lod_heap(
            *_heap_args(RNG_SEED), 200),
        "parse_octree_meta": lambda m: m.parse_octree_meta(meta),
        "tree_levels": lambda m: [
            m.tree_levels(c, depth, max_split, mp, root, stop)
            for c, depth, max_split, mp, root, stop in _tree_levels_args()],
    }
    for dt in (np.uint8, np.uint16, np.float32, np.float64):
        cases[f"gather_encode_{np.dtype(dt).name}"] = (
            lambda m, dt=dt: m.gather_encode(pos, idx, node_min, node_edge,
                                             offsets, dt))
    return cases


def _tree_levels_args():
    """Sorted codes for native tree_levels: the whole tree at depth 21, a
    bucket subtree (root and stop level 2) and a re-rooted deep sub-build
    (depth 12 and 19, as a planet-box cell), runs of one code included."""
    rng = np.random.default_rng(RNG_SEED + 2)
    out = []
    for depth, max_split, mp, root, stop in ((21, 21, 1000, 0, 0),
                                             (21, 21, 100, 2, 2),
                                             (21, 18, 50, 0, 3),
                                             (12, 12, 500, 0, 0),
                                             (19, 19, 80, 1, 4)):
        n = 40_000
        codes = rng.integers(0, 2 ** (3 * depth), n, dtype=np.uint64)
        codes[: n // 2] &= ~np.uint64(2 ** (3 * depth - 12) - 1)
        codes[n // 2: n // 2 + 3000] = codes[n // 2]
        if root:
            top = np.uint64(3 * (depth - root))
            codes = (codes[0] >> top << top) | (
                codes & np.uint64((1 << int(top)) - 1))
        out.append((np.sort(codes), depth, max_split, mp, root, stop))
    return out


def rng_codes(seed):
    rng = np.random.default_rng(seed + 1)
    codes = rng.integers(0, 2 ** 51, 200_000, dtype=np.uint64)
    codes[::3] = codes[0]
    return codes


def _flatten(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _flatten(o)]
    return [out]


NATIVE_NAMES = [
    "cull_lod_heap", "cull_lod_select", "counting_argsort", "decode_positions",
    "encode_positions_u16", "encode_positions_u8", "gather_encode_float32", "gather_encode_float64",
    "gather_encode_uint16", "gather_encode_uint8", "group_levels_full",
    "morton_encode", "parse_octree_meta", "quantize_morton",
    "radix_argsort_u64", "take_rows", "tree_levels",
]


@pytest.mark.parametrize("name", NATIVE_NAMES)
def test_native_function_bit_equal_to_jax(name):
    assert native.available() and jax_native.available()
    cases = _native_cases()
    assert sorted(cases) == sorted(NATIVE_NAMES)
    got = _flatten(cases[name](native))
    want = _flatten(cases[name](jax_native))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            _same(g, w)
        else:
            assert g == w


def test_native_library_has_only_the_ports_functions():
    """The position encode is in (native.encode_positions calls it); the
    web decode, which no Python wrapper calls, is not; ABI 5 keeps a
    library built before the encode came in from loading."""
    h = native.lib()
    assert not hasattr(h, "decode_to_f32_relative")
    for fn in ("encode_positions_u8", "encode_positions_u16", "tree_levels"):
        assert hasattr(h, fn)
    assert h.pcv_native_abi_version() == 5


# --- protos, codec, node_id ---------------------------------------------------


def _octree_meta_bytes(seed, version=13):
    from point_cloud_viewer_tpu.protos import meta as M

    rng = np.random.default_rng(seed)
    nodes = [M.OctreeNodeProto(
        id=(int(level) << 120) | int(p), num_points=int(c),
        position_encoding=M.PositionEncodingProto(int(e)))
        for level, p, c, e in zip(rng.integers(0, 22, 500),
                                  rng.integers(0, 2 ** 40, 500),
                                  rng.integers(0, 10 ** 6, 500),
                                  rng.integers(1, 5, 500))]
    return M.MetaProto(
        version=version,
        bounding_box=M.BoundingBoxProto(min=(-1.5, 2.0, 0.0),
                                        max=(3.0, 4.25, 1e9)),
        octree=M.OctreeMetaProto(resolution=0.001, nodes=nodes)).encode()


def _meta_fields(meta):
    octree = meta.octree
    return (meta.version, tuple(meta.bounding_box.min),
            tuple(meta.bounding_box.max), octree.resolution,
            [(n.id, n.num_points, int(n.position_encoding))
             for n in octree.nodes])


def _case_meta_roundtrip():
    from point_cloud_viewer_tpu.protos import meta as JM
    from point_cloud_viewer_tpu_torch.protos import meta as PM

    for version in (11, 12, 13):
        raw = _octree_meta_bytes(RNG_SEED + version, version)
        got, want = PM.MetaProto.decode(raw), JM.MetaProto.decode(raw)
        assert _meta_fields(got) == _meta_fields(want)
        if version == 13:
            assert got.encode() == want.encode() == raw
    nodes = [PM.OctreeNodeProto(id=(3 << 120) | 5, num_points=-1,
                                position_encoding=PM.PositionEncodingProto(2))]
    mine = PM.MetaProto(bounding_box=PM.BoundingBoxProto(max=(1.0, 2.0, 3.0)),
                        octree=PM.OctreeMetaProto(resolution=0.5, nodes=nodes))
    theirs = JM.MetaProto(
        bounding_box=JM.BoundingBoxProto(max=(1.0, 2.0, 3.0)),
        octree=JM.OctreeMetaProto(resolution=0.5, nodes=[
            JM.OctreeNodeProto(id=(3 << 120) | 5, num_points=-1,
                               position_encoding=JM.PositionEncodingProto(2))]))
    assert mine.encode() == theirs.encode()
    for bad in (b"\x08\x63", b"\x08\x0d"):  # version 99; no octree at all
        with pytest.raises(ValueError) as e_port:
            PM.MetaProto.decode(bad)
        with pytest.raises(ValueError) as e_jax:
            JM.MetaProto.decode(bad)
        assert str(e_port.value) == str(e_jax.value)


def _case_codec():
    from point_cloud_viewer_tpu.ops import codec as JC
    from point_cloud_viewer_tpu_torch.ops import codec as PC

    rng = np.random.default_rng(RNG_SEED)
    for edge, res in ((1.0, 0.001), (100.0, 1e-3), (1e6, 1e-3), (0.0, 1.0),
                      (5.0, 10.0), (1e9, 1e-6)):
        assert int(PC.position_encoding_for(edge, res)) == int(
            JC.position_encoding_for(edge, res))
    pos = rng.random((20_000, 3)) * 4.0 - 1.0
    mn, edge = rng.random((20_000, 3)), rng.random(20_000) * 2.0
    edge[:10] = 0.0
    for enc in (1, 2, 3, 4):
        e = PC.encode_positions(pos, mn, edge, PC.PositionEncoding(enc))
        _same(e, JC.encode_positions(pos, mn, edge, JC.PositionEncoding(enc)))
        _same(PC.decode_positions(e, mn, edge, PC.PositionEncoding(enc)),
              JC.decode_positions(e, mn, edge, JC.PositionEncoding(enc)))


def _case_node_id():
    from point_cloud_viewer_tpu.math.geometry import Cube as JCube
    from point_cloud_viewer_tpu.octree import node_id as JN
    from point_cloud_viewer_tpu_torch.math.geometry import Cube as PCube
    from point_cloud_viewer_tpu_torch.octree import node_id as PN

    rng = np.random.default_rng(RNG_SEED)
    levels = rng.integers(0, 41, 3000).astype(np.uint8)
    hi = rng.integers(0, 2 ** 56, 3000, dtype=np.uint64) >> np.uint64(4)
    lo = rng.integers(0, 2 ** 63, 3000, dtype=np.uint64)
    root_p, root_j = PCube([1.0, -2.0, 3.0], 17.5), JCube([1.0, -2.0, 3.0], 17.5)
    for g, w in zip(PN.bounding_cubes2(levels, hi, lo, root_p),
                    JN.bounding_cubes2(levels, hi, lo, root_j)):
        _same(g, w)
    short = levels % 22
    for g, w in zip(PN.bounding_cubes(short, lo >> np.uint64(1), root_p),
                    JN.bounding_cubes(short, lo >> np.uint64(1), root_j)):
        _same(g, w)
    ids = [JN.NodeId.from_level_index(int(l), int(p))
           for l, p in zip(short, lo >> np.uint64(1))]
    mine = [PN.NodeId.from_level_index(int(l), int(p))
            for l, p in zip(short, lo >> np.uint64(1))]
    assert [str(n) for n in mine] == [str(n) for n in ids]
    for g, w in zip(PN.unpack_ids(mine), JN.unpack_ids(ids)):
        _same(g, w)
    # find_bounding_cube over the format's range (120-bit paths, level 40)
    for level, h, l in zip(levels[:500], hi[:500], lo[:500]):
        path = ((int(h) << 64) | int(l)) & ((1 << (3 * int(level))) - 1)
        g = PN.NodeId.from_level_index(int(level), path).find_bounding_cube(
            root_p)
        w = JN.NodeId.from_level_index(int(level), path).find_bounding_cube(
            root_j)
        _same(g.min, w.min)
        assert g.edge_length == w.edge_length


@pytest.mark.parametrize("case", ["meta_roundtrip", "codec", "node_id"])
def test_wire_and_codec_copies_match_jax(case):
    {"meta_roundtrip": _case_meta_roundtrip, "codec": _case_codec,
     "node_id": _case_node_id}[case]()


# --- io.ply --------------------------------------------------------------------


def _ply(path, n, fmt, offset=None, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3)) * 10.0
    rgb = rng.integers(0, 256, (n, 3))
    inten = rng.random(n).astype(np.float32)
    props = ("property double x\nproperty double y\nproperty float z\n"
             "property uchar red\nproperty uchar green\nproperty uchar blue\n"
             "property uchar alpha\nproperty float intensity\n"
             "property short skipped\n")
    head = f"ply\nformat {fmt} 1.0\n"
    if offset is not None:
        head += "comment offset: {} {} {}\n".format(*offset)
    head += f"element vertex {n}\n{props}end_header\n"
    with open(path, "wb") as f:
        f.write(head.encode("ascii"))
        if fmt == "ascii":
            for i in range(n):
                f.write((f"{pos[i, 0]:.17g} {pos[i, 1]:.17g} "
                         f"{np.float32(pos[i, 2]):.9g} {rgb[i, 0]} "
                         f"{rgb[i, 1]} {rgb[i, 2]} 7 {inten[i]:.9g} -3\n")
                        .encode("ascii"))
            return
        e = "<" if fmt == "binary_little_endian" else ">"
        rows = np.empty(n, dtype=[("x", e + "f8"), ("y", e + "f8"),
                                  ("z", e + "f4"), ("r", "u1"), ("g", "u1"),
                                  ("b", "u1"), ("a", "u1"),
                                  ("i", e + "f4"), ("s", e + "i2")])
        rows["x"], rows["y"], rows["z"] = pos.T
        rows["r"], rows["g"], rows["b"] = rgb.T
        rows["a"], rows["i"], rows["s"] = 7, inten, -3
        rows.tofile(f)


@pytest.mark.parametrize("fmt,offset", [
    ("binary_little_endian", None), ("binary_little_endian", (1.5, -2., 3.)),
    ("binary_big_endian", None), ("ascii", None)])
def test_ply_reader_batches_match_jax(tmp_path, fmt, offset):
    from point_cloud_viewer_tpu.io.ply import PlyReader as JaxReader
    from point_cloud_viewer_tpu_torch.io.ply import PlyReader

    path = str(tmp_path / "c.ply")
    n = 2_500 if fmt == "ascii" else 120_000
    _ply(path, n, fmt, offset, seed=len(fmt))
    got = list(PlyReader(path, batch_size=50_000))
    want = list(JaxReader(path, batch_size=50_000))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        _same(g.position, w.position)
        assert list(g.attributes) == list(w.attributes)
        for name in w.attributes:
            _same(g.attributes[name], w.attributes[name])


# --- octree.octree ---------------------------------------------------------------


@pytest.fixture(scope="module")
def built_tree(tmp_path_factory):
    """The same 160k-point cloud built by the port (CPU route) and by the
    JAX package."""
    rng = np.random.default_rng(RNG_SEED)
    n = 160_000
    position = np.concatenate([rng.random((n // 2, 3)) * 40.0,
                               12.0 + rng.normal(0.0, 0.3, (n // 2, 3))])
    attrs = {"color": rng.integers(0, 256, (n, 3), dtype=np.uint8),
             "intensity": rng.random(n).astype(np.float32)}
    port = str(tmp_path_factory.mktemp("port"))
    ref = str(tmp_path_factory.mktemp("jax"))
    build_octree(port, 0.001, JaxBatch(position=position, attributes=attrs),
                 device="cpu")
    jax_build(ref, 0.001, JaxBatch(position=position, attributes=attrs))
    return port, ref


def _camera_matrices():
    from point_cloud_viewer_tpu_torch.viewer.camera import Camera

    out = []
    for i, (x, y, z) in enumerate([(20, 20, 90), (-30, 5, 10), (12, 12, 12),
                                   (60, 60, 60)]):
        cam = Camera(320, 240)
        cam.position = np.array([x, y, z], dtype=float)
        cam.theta, cam.phi = 0.4 * i, 0.3 + 0.2 * i
        out.append(cam.world_to_gl())
    return out


@pytest.mark.parametrize("max_nodes", [None, 40])
def test_octree_fields_and_visible_nodes_match_jax(built_tree, max_nodes):
    from point_cloud_viewer_tpu.octree.octree import Octree as JaxOctree
    from point_cloud_viewer_tpu_torch.octree.octree import Octree

    port_dir, ref_dir = built_tree
    mine, theirs = Octree.from_directory(port_dir), JaxOctree.from_directory(
        ref_dir)
    for field in ("levels", "path_hi", "path_lo", "num_points", "cube_mins",
                  "cube_edges"):
        _same(getattr(mine, field), getattr(theirs, field))
    for matrix in _camera_matrices():
        got = mine.get_visible_nodes(matrix, max_nodes=max_nodes)
        want = theirs.get_visible_nodes(matrix, max_nodes=max_nodes)
        assert [n.value for n in got] == [n.value for n in want]
    node = theirs.node_ids[len(theirs) // 2]
    a = mine.points_in_node(type(mine.node_ids[0])(node.value))
    b = theirs.points_in_node(node)
    _same(a.position, b.position)
    for name in b.attributes:
        _same(a.attributes[name], b.attributes[name])


# --- the numpy fallbacks, with the native library unloaded ---------------------


@pytest.fixture
def no_native(monkeypatch):
    """Both packages' host libraries unloaded: every native entry point
    returns None and its caller takes its numpy fallback."""
    monkeypatch.setattr(native, "lib", lambda: None)
    monkeypatch.setattr(jax_native, "lib", lambda: None)
    assert not native.available() and not jax_native.available()


@pytest.mark.parametrize("route", ["in_core", "streamed"])
def test_build_without_native_library_matches_jax(tmp_path, no_native, route):
    from point_cloud_viewer_tpu.octree import streaming as JS
    from point_cloud_viewer_tpu_torch.octree import streaming as PS
    from tests.conftest import assert_dirs_byte_equal

    rng = np.random.default_rng(RNG_SEED + 1)
    n = 30_000
    position = np.concatenate([rng.random((n // 2, 3)) * 20.0,
                               6.0 + rng.normal(0.0, 0.2, (n // 2, 3))])
    batch = JaxBatch(position=position, attributes={
        "color": rng.integers(0, 256, (n, 3), dtype=np.uint8),
        "intensity": rng.random(n).astype(np.float32)})
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    if route == "in_core":
        build_octree(port, 0.001, batch, device="cpu")
        jax_build(ref, 0.001, batch)
    else:
        PS.build_octree_streaming(port, 0.001, batch, bucket_levels=1,
                                  spill_directory=str(tmp_path / "spill"),
                                  device="cpu")
        JS.build_octree_streaming(ref, 0.001, batch, bucket_levels=1)
    assert_dirs_byte_equal(ref, port, context=f"{route} build, no native")


@pytest.mark.parametrize("max_nodes", [None, 40])
def test_host_cull_without_native_library_matches_jax(built_tree, no_native,
                                                      max_nodes):
    """The Octree's meta parse, numpy cull and node decode, and the
    viewer's host cull, each against the JAX package's fallback."""
    from point_cloud_viewer_tpu.octree.octree import Octree as JaxOctree
    from point_cloud_viewer_tpu.ops import culling as JU
    from point_cloud_viewer_tpu_torch.octree.octree import Octree
    from point_cloud_viewer_tpu_torch.ops import culling as PU

    port_dir, ref_dir = built_tree
    mine, theirs = Octree.from_directory(port_dir), JaxOctree.from_directory(
        ref_dir)
    for field in ("levels", "path_hi", "path_lo", "num_points", "cube_mins",
                  "cube_edges"):
        _same(getattr(mine, field), getattr(theirs, field))
    for matrix in _camera_matrices():
        got = mine.get_visible_nodes(matrix, max_nodes=max_nodes)
        want = theirs.get_visible_nodes(matrix, max_nodes=max_nodes)
        assert [n.value for n in got] == [n.value for n in want]
    node = theirs.node_ids[len(theirs) // 2]
    a = mine.points_in_node(type(mine.node_ids[0])(node.value))
    b = theirs.points_in_node(node)
    _same(a.position, b.position)
    k = 4000 if max_nodes is None else 40
    args = _cull_args(k, RNG_SEED, np.float32)
    for g, w in zip(PU.frustum_cull_lod_select_host(*args),
                    JU.frustum_cull_lod_select_host(*args)):
        _same(g, w)


# --- viewer.camera -----------------------------------------------------------------


@pytest.mark.parametrize("width,height", [(1280, 720), (640, 480), (97, 31)])
def test_camera_matrices_match_jax(width, height):
    from point_cloud_viewer_tpu.viewer.camera import Camera as JaxCamera
    from point_cloud_viewer_tpu_torch.viewer.camera import Camera

    mine, theirs = Camera(width, height), JaxCamera(width, height)
    for step in range(5):
        for cam in (mine, theirs):
            cam.position = np.array([3.0 * step, -2.0, 7.5])
            cam.theta, cam.phi = 0.7 * step, -0.2 + 0.1 * step
            cam.moving["forward"] = step % 2 == 0
            cam.turning["left"] = step % 3 == 0
            cam.moved = True
        assert mine.update(1 / 60) == theirs.update(1 / 60)
        _same(mine.world_to_gl(), theirs.world_to_gl())
        _same(mine.position, theirs.position)
        _same(mine.projection.matrix, theirs.projection.matrix)


# --- utils.progress ----------------------------------------------------------------


@pytest.mark.parametrize("echo", [None, "build_octree: encode+write"])
def test_timed_phase_matches_jax(echo, capsys):
    """The copy records the same keys and prints the same breadcrumb (its
    seconds masked), also when the phase raises."""
    import re

    from point_cloud_viewer_tpu.utils import progress as JP
    from point_cloud_viewer_tpu_torch.utils import progress as PP

    said = []
    for mod in (PP, JP):
        times = {"other": 1.0}
        with mod.timed_phase(times, "k", echo=echo):
            pass
        with pytest.raises(KeyError):
            with mod.timed_phase(times, "k", echo=echo):
                raise KeyError("boom")
        with mod.timed_phase(None, "unused", echo=echo):
            pass
        assert sorted(times) == ["k", "other"] and times["k"] >= 0.0
        out = capsys.readouterr()
        assert out.out == ""
        said.append(re.sub(r"\d+\.\d{3}s", "X.XXXs", out.err))
    assert said[0] == said[1]
    assert said[0] == ("" if echo is None else f"{echo}: X.XXXs\n" * 3)


# --- the query path's host modules -------------------------------------------------


def _packages():
    """(port, JAX) module namespaces of the query path's host copies."""
    import importlib

    names = ("math.geometry", "math.sat", "math.intervals", "math.wgs84",
             "math.web_mercator", "math.s2", "s2_cells.cell_union",
             "query.location", "protos.meta", "utils.progress")
    out = []
    for pkg in ("point_cloud_viewer_tpu_torch", "point_cloud_viewer_tpu"):
        mods = {n.split(".")[1]: importlib.import_module(f"{pkg}.{n}")
                for n in names}
        out.append(type("Mods", (), mods))
    return out


def _query_geometries(M, rng):
    """An Aabb, an Obb, a Frustum and a WebMercatorRect built by the modules
    M of either package, from rng's draws."""
    G = M.geometry
    iso = G.Isometry.from_axis_angle(rng.normal(size=3), rng.random() * 3,
                                     translation=rng.normal(size=3) * 5)
    eye = G.Isometry.from_axis_angle([0, 1, 0], 0.4,
                                     translation=[0.0, 0.0, 30.0])
    rect = M.web_mercator.WebMercatorRect.from_zoomed_coordinates(
        [1000.25, 2000.5], [1003.75, 2002.0], 4)
    return [G.Aabb(rng.normal(size=3) * 4, rng.normal(size=3) * 4),
            G.Obb(iso, rng.random(3) * 6 + 0.5),
            G.Frustum.new(eye, G.Perspective.from_fov(1.1, 0.9, 1.0, 60.0)),
            rect]


def _query_case_geometry_sat_location(P, J, rng):
    pts = rng.random((20_000, 3)) * 40.0 - 20.0
    lo = rng.random((3_000, 3)) * 40.0 - 20.0
    hi = lo + rng.random((3_000, 1)) * 6.0
    corners = lo[:, None, :] + P.geometry._CORNER_SIGNS * (hi - lo)[:, None]
    seed = int(rng.integers(1 << 30))
    for g, w in zip(_query_geometries(P, np.random.default_rng(seed)),
                    _query_geometries(J, np.random.default_rng(seed))):
        if not isinstance(g, P.web_mercator.WebMercatorRect):
            _same(g.contains(pts), w.contains(pts))
        _same(g.corners(), w.corners())
        gi, wi = g.intersector(), w.intersector()
        for f in ("corners", "edges", "face_normals"):
            _same(getattr(gi, f), getattr(wi, f))
        ga, wa = gi.cached_axes_for_aabb(), wi.cached_axes_for_aabb()
        _same(ga.axes, wa.axes)
        _same(ga.intersect(corners), wa.intersect(corners))
        _same(ga.intersect_bounds(lo, hi), wa.intersect_bounds(lo, hi))
        gl, wl = P.location.location_for(g), J.location.location_for(w)
        _same(gl.intersects_bounds(lo, hi), wl.intersects_bounds(lo, hi))
        _same(gl.intersects_aabbs(corners), wl.intersects_aabbs(corners))
        fg, fw = gl.fully_inside_bounds(lo, hi), wl.fully_inside_bounds(lo,
                                                                          hi)
        assert (fg is None) == (fw is None)
        if fg is not None:
            _same(fg, fw)
    box = _query_geometries(P, rng)[0]
    jbox = J.geometry.Aabb(box.mins, box.maxs)
    iso = P.geometry.Isometry.from_axis_angle([1, 2, 3], 0.5, [1, 2, 3])
    jiso = J.geometry.Isometry(iso.rotation, iso.translation)
    _same(box.transform(iso).mins, jbox.transform(jiso).mins)
    _same(box.to_obb().contains(pts), jbox.to_obb().contains(pts))
    _same(P.sat.dedup_axes(np.concatenate([pts[:50], -pts[:50]])),
          J.sat.dedup_axes(np.concatenate([pts[:50], -pts[:50]])))
    all_p, all_j = P.location.AllPoints(), J.location.AllPoints()
    _same(all_p.contains(pts), all_j.contains(pts))
    _same(all_p.fully_inside_bounds(lo, hi), all_j.fully_inside_bounds(lo,
                                                                       hi))


def _query_case_intervals(P, J, rng):
    values = rng.normal(size=5000).astype(np.float32)
    for lo, hi in ((-0.5, 0.5), (0.0, 0.0), (-np.inf, 1.0)):
        _same(P.intervals.ClosedInterval(lo, hi).contains(values),
              J.intervals.ClosedInterval(lo, hi).contains(values))
    assert (P.intervals.ClosedInterval.from_str("-1.5,2")
            == P.intervals.ClosedInterval(-1.5, 2.0))
    for bad in ("1", "2,1"):
        with pytest.raises(ValueError) as e_port:
            P.intervals.ClosedInterval.from_str(bad)
        with pytest.raises(ValueError) as e_jax:
            J.intervals.ClosedInterval.from_str(bad)
        assert str(e_port.value) == str(e_jax.value)


def _query_case_wgs84_web_mercator(P, J, rng):
    lat = rng.uniform(-1.5, 1.5, 5000)
    lon = rng.uniform(-np.pi, np.pi, 5000)
    alt = rng.uniform(-500.0, 9000.0, 5000)
    ecef = P.wgs84.geodetic_to_ecef(lat, lon, alt)
    _same(ecef, J.wgs84.geodetic_to_ecef(lat, lon, alt))
    for g, w in zip(P.wgs84.ecef_to_geodetic(ecef),
                    J.wgs84.ecef_to_geodetic(ecef)):
        _same(g, w)
    fp, fj = (m.wgs84.local_frame_from_lat_lng(48.1, 11.6) for m in (P, J))
    _same(fp.rotation, fj.rotation)
    _same(fp.translation, fj.translation)
    _same(P.web_mercator.ecef_to_web_mercator(ecef),
          J.web_mercator.ecef_to_web_mercator(ecef))
    uv = rng.random((5000, 2))
    for g, w in zip(P.web_mercator.web_mercator_to_lat_lng(uv),
                    J.web_mercator.web_mercator_to_lat_lng(uv)):
        _same(g, w)
    for args in (([1.0, 2.0], [3.0, 5.0], 2), ([1.0, 2.0], [3.0, 5.0], 30),
                 ([500.0, 2.0], [3.0, 5.0], 0), ([3.0, 5.0], [1.0, 2.0], 2)):
        g = P.web_mercator.WebMercatorRect.from_zoomed_coordinates(*args)
        w = J.web_mercator.WebMercatorRect.from_zoomed_coordinates(*args)
        assert (g is None) == (w is None)
        if g is not None:
            _same(g.contains(ecef), w.contains(ecef))


def _query_case_s2_cell_union(P, J, rng):
    pts = rng.normal(size=(20_000, 3)) * 6.37e6
    pts[::7, 0] = pts[::7, 1]
    leaves = P.s2.leaf_cell_ids_from_points(pts)
    _same(leaves, J.s2.leaf_cell_ids_from_points(pts))
    for g, w in zip(P.s2.cell_id_to_face_ij(leaves),
                    J.s2.cell_id_to_face_ij(leaves)):
        _same(g, w)
    levels = rng.integers(0, 30, len(leaves))
    cells = np.array([P.s2.parent(c, int(lv)) for c, lv in
                      zip(leaves[:3000], levels[:3000])], dtype=np.uint64)
    _same(cells, np.array([J.s2.parent(c, int(lv)) for c, lv in
                           zip(leaves[:3000], levels[:3000])],
                          dtype=np.uint64))
    for fn in ("level_of", "range_min", "range_max", "cell_corners_xyz"):
        _same(getattr(P.s2, fn)(cells), getattr(J.s2, fn)(cells))
    _same(P.s2.contains(cells, leaves[:3000]),
          J.s2.contains(cells, leaves[:3000]))
    assert [P.s2.token(int(c)) for c in cells] == [J.s2.token(int(c))
                                                    for c in cells]
    assert P.s2.children(int(cells[5])) == J.s2.children(int(cells[5]))
    rect_p = P.s2.LatLngRect.from_points(pts[:4] / 1e3 + [6.37e6, 1e5, 2e5])
    rect_j = J.s2.LatLngRect.from_points(pts[:4] / 1e3 + [6.37e6, 1e5, 2e5])
    _same(rect_p.intersects_cells(cells), rect_j.intersects_cells(cells))
    ids = [int(c) for c in cells[:200]]
    up, uj = P.cell_union.CellUnion(ids), J.cell_union.CellUnion(ids)
    _same(up.ids, uj.ids)
    _same(up.contains_cell_ids(leaves), uj.contains_cell_ids(leaves))
    _same(up.contains(pts), uj.contains(pts))
    lo = pts[:500] - 5e4
    _same(up.intersects_bounds(lo, lo + 1e5), uj.intersects_bounds(lo,
                                                                   lo + 1e5))
    for g, w in zip(P.cell_union.cell_world_bounds(up.ids),
                    J.cell_union.cell_world_bounds(uj.ids)):
        _same(g, w)


def _query_case_s2_meta_and_parse_aabb(P, J, rng):
    cells = [J.meta.S2CellProto(id=int(c), num_points=int(n)) for c, n in zip(
        rng.integers(0, 2 ** 63, 50, dtype=np.uint64) * np.uint64(2) + np.uint64(1),
        rng.integers(0, 10 ** 6, 50))]
    attrs = [J.meta.AttributeProto(name="color", data_type=J.meta.AttributeDataType(3))]
    raw = J.meta.MetaProto(s2=J.meta.S2MetaProto(cells=cells, attributes=attrs),
                           bounding_box=J.meta.BoundingBoxProto(
                               min=(1.0, 2.0, 3.0), max=(4.0, 5.0, 6.0))).encode()
    got = P.meta.MetaProto.decode(raw)
    assert got.octree is None and got.encode() == raw
    assert [(c.id, c.num_points) for c in got.s2.cells] == [
        (c.id, c.num_points) for c in cells]
    assert [(a.name, int(a.data_type)) for a in got.s2.attributes] == [
        ("color", 3)]
    text = "1,-2,3.5,4,5,-6"
    g, w = P.progress.parse_aabb(text), J.progress.parse_aabb(text)
    _same(g.mins, w.mins)
    _same(g.maxs, w.maxs)
    with pytest.raises(ValueError) as e_port:
        P.progress.parse_aabb("1,2,3")
    with pytest.raises(ValueError) as e_jax:
        J.progress.parse_aabb("1,2,3")
    assert str(e_port.value) == str(e_jax.value)


@pytest.mark.parametrize("case", [
    "geometry_sat_location", "intervals", "wgs84_web_mercator",
    "s2_cell_union", "s2_meta_and_parse_aabb"])
def test_query_host_copies_match_jax(case):
    P, J = _packages()
    globals()[f"_query_case_{case}"](P, J, np.random.default_rng(RNG_SEED))


# --- the x-ray path's host modules ---------------------------------------------

# The copies that stand unchanged: each is its original's text plus one
# docstring line naming the source.
_XRAY_COPIES = ("protos/xray_meta.py", "utils/extension.py", "xray/quadtree.py",
                "xray/colormap.py", "xray/meta.py", "xray/merge.py",
                "xray/inpaint.py", "cli/merge_xray_quadtrees.py",
                "cli/inpaint_xray_quadtree.py", "cli/upgrade_xray_quadtree.py")


@pytest.mark.parametrize("path", _XRAY_COPIES)
def test_xray_copies_are_their_originals(path):
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "point_cloud_viewer_tpu", path)) as f:
        original = f.read()
    with open(os.path.join(root, "point_cloud_viewer_tpu_torch", path)) as f:
        copy = f.read()
    n = original.count("\n")
    note = f"\n\nCopy of point_cloud_viewer_tpu/{path}:1-{n}, unchanged.\n"
    assert copy.count(note) == 1
    # The note went in before the docstring's closing quotes, which stood
    # on a line of their own or after its last word.
    assert original in (copy.replace(note, "\n"), copy.replace(note, ""))


def _xray_packages():
    """(port, JAX) namespaces of the x-ray path's host modules."""
    import importlib

    names = ("protos.xray_meta", "utils.extension", "utils.progress",
             "xray.quadtree", "xray.colormap", "xray.meta")
    out = []
    for pkg in ("point_cloud_viewer_tpu_torch", "point_cloud_viewer_tpu"):
        mods = {n.split(".")[1]: importlib.import_module(f"{pkg}.{n}")
                for n in names}
        out.append(type("Mods", (), mods))
    return out


def _xray_meta_bytes(M, rng, version=3):
    X = M.xray_meta
    ids = sorted({(int(lv), int(rng.integers(0, 4 ** lv)))
                  for lv in rng.integers(0, 9, 300)})
    return X.XrayMetaProto(
        version=version,
        bounding_rect=X.RectProto(min=tuple(rng.normal(size=2) * 1e3),
                                  edge_length=float(rng.random() * 500)),
        deepest_level=8, tile_size=256,
        nodes=[X.XrayNodeIdProto(lv, ix) for lv, ix in ids]).encode()


def _xray_case_meta_wire(P, J, rng):
    import struct

    from point_cloud_viewer_tpu.protos import pbwire as JW

    seed = int(rng.integers(1 << 30))
    raw = _xray_meta_bytes(P, np.random.default_rng(seed))
    assert raw == _xray_meta_bytes(J, np.random.default_rng(seed))
    got, want = P.xray_meta.XrayMetaProto.decode(raw), \
        J.xray_meta.XrayMetaProto.decode(raw)
    assert got.encode() == want.encode() == raw
    # A v2 rect: Vector2f min in field 1, f32 edge in field 2.
    w = JW.FieldWriter()
    v = JW.FieldWriter()
    v.float32(1, 1.5)
    v.float32(2, -2.25)
    w.message(1, v.finish())
    w.float32(2, 64.0)
    rect = w.finish()
    got, want = (M.xray_meta.RectProto.decode(rect) for M in (P, J))
    assert (got.min, got.edge_length) == (want.min, want.edge_length) == (
        (1.5, -2.25), 64.0)
    for version in (2, 7):
        raw = _xray_meta_bytes(J, np.random.default_rng(seed), version)
        if version == 2:
            assert (P.xray_meta.XrayMetaProto.decode(raw).encode()
                    == J.xray_meta.XrayMetaProto.decode(raw).encode())
            continue
        with pytest.raises(ValueError) as e_port:
            P.xray_meta.XrayMetaProto.decode(raw)
        with pytest.raises(ValueError) as e_jax:
            J.xray_meta.XrayMetaProto.decode(raw)
        assert str(e_port.value) == str(e_jax.value)
    assert struct.calcsize("<d") == 8


def _xray_case_quadtree(P, J, rng):
    PQ, JQ = P.quadtree, J.quadtree
    rect = (float(rng.normal() * 100), float(rng.normal() * 100), 409.6)
    for _ in range(300):
        level = int(rng.integers(0, 14))
        index = int(rng.integers(0, 4 ** level)) if level else 0
        p, j = PQ.QuadNodeId(level, index), JQ.QuadNodeId(level, index)
        assert str(p) == str(j)
        assert PQ.QuadNodeId.from_str(str(j)) == p
        assert p.to_spatial() == PQ.SpatialNodeId(*vars(j.to_spatial())
                                                  .values())
        for d in PQ.Direction:
            pn, jn = p.neighbor(d), j.neighbor(JQ.Direction[d.name])
            assert (pn is None) == (jn is None)
            if pn is not None:
                assert (pn.level, pn.index) == (jn.level, jn.index)
            assert d.opposite().name == JQ.Direction[d.name].opposite().name
        pr, jr = (n.find_bounding_rect(M.Rect(*rect)) for n, M in
                  ((p, PQ), (j, JQ)))
        assert (pr.min_x, pr.min_y, pr.edge_length, pr.max_x, pr.max_y,
                pr.center()) == (jr.min_x, jr.min_y, jr.edge_length,
                                 jr.max_x, jr.max_y, jr.center())
        if level:
            assert p.parent().index == j.parent().index
            assert p.child_index_in_parent() == j.child_index_in_parent()
    for root, level in (("r", 3), ("r21", 5), ("r3", 3)):
        pids = PQ.nodes_at_level(PQ.QuadNodeId.from_str(root), level)
        jids = JQ.nodes_at_level(JQ.QuadNodeId.from_str(root), level)
        assert [str(n) for n in pids] == [str(n) for n in jids]
        _same(PQ.node_rects(pids, PQ.Rect(*rect)),
              JQ.node_rects(jids, JQ.Rect(*rect)))
    with pytest.raises(ValueError):
        PQ.QuadNodeId.from_str("x12")


def _xray_case_colormap_and_meta(P, J, rng):
    vals = np.concatenate([np.linspace(0.0, 1.0, 1001),
                           rng.random(5000), [-0.1, 1.2]])
    for f in ("jet", "monochrome"):
        _same(getattr(P.colormap, f)(vals), getattr(J.colormap, f)(vals))
    _same(P.colormap.monochrome(vals, base=(0.2, 0.4, 0.6, 1.0)),
          J.colormap.monochrome(vals, base=(0.2, 0.4, 0.6, 1.0)))
    raw = _xray_meta_bytes(J, rng)
    pm = P.meta.XrayMeta(P.xray_meta.XrayMetaProto.decode(raw))
    jm = J.meta.XrayMeta(J.xray_meta.XrayMetaProto.decode(raw))
    assert pm.to_proto().encode() == jm.to_proto().encode()
    assert str(pm.root_node()) == str(jm.root_node())
    cam = np.array([[0.01, 0, 0, -0.3], [0, 0.012, 0, 0.1],
                    [0, 0, 0.2, 0], [0, 0, 0, 1.0]])
    entries = list(cam.T.reshape(-1))
    for level in range(9):
        assert sorted(str(n) for n in pm.iter_level(level)) == sorted(
            str(n) for n in jm.iter_level(level))
        got = pm.get_nodes_for_level(level, entries)
        want = jm.get_nodes_for_level(level, entries)
        assert sorted(vars(t).values() for t in got) == sorted(
            vars(t).values() for t in want)
    for m in (pm, jm):
        with pytest.raises(ValueError):
            m.get_nodes_for_level(2, [1.0] * 15)


class _Extension:
    """A plugin for the extension case: a flag and a transform."""

    def add_arguments(self, parser):
        parser.add_argument("--shift", type=float, default=0.0)

    def query_from_global(self, args):
        return ("shift", args.shift)


def _xray_case_extension_and_progress(P, J, rng):
    import argparse
    import io
    import re

    spec = f"{__name__}:_Extension"
    said = []
    for M in (P, J):
        ext = M.extension.load_extension(spec)
        assert isinstance(ext, _Extension)
        assert M.extension.load_extension(None) is None
        parser = argparse.ArgumentParser()
        M.extension.apply_hook(ext, "add_arguments", parser)
        args = parser.parse_args(["--shift", "2.5"])
        said.append((M.extension.apply_hook(ext, "query_from_global", args),
                     M.extension.apply_hook(ext, "after_build", args,
                                            default="none"),
                     M.extension.apply_hook(None, "x", default=3)))
        stream = io.StringIO()
        bar = M.progress.ProgressBar(7, "Building level 5", refresh_s=0.0,
                                     stream=stream)
        for _ in range(7):
            bar.inc()
        bar.finish()
        said.append(re.sub(r"\d+\.\ds", "X.Xs", stream.getvalue()))
        said.append(M.progress.parse_key_val("intensity=0.5,2=x"))
        with pytest.raises(ValueError) as e:
            M.progress.parse_key_val("no-equals")
        said.append(str(e.value))
    assert said[:4] == said[4:]


@pytest.mark.parametrize("case", ["meta_wire", "quadtree",
                                  "colormap_and_meta",
                                  "extension_and_progress"])
def test_xray_host_copies_match_jax(case):
    P, J = _xray_packages()
    globals()[f"_xray_case_{case}"](P, J, np.random.default_rng(RNG_SEED))


# --- the viewers' and web servers' host modules ----------------------------------

_VIEWER_COPIES = ("viewer/camera.py", "viewer/input.py", "viewer/terrain.py",
                  "viewer/gl/api.py", "viewer/gl/core.py",
                  "viewer/gl/renderer.py",
                  "viewer/gl/terrain.py", "viewer/gl/shaders/__init__.py",
                  "viewer/web_backend.py", "xray/backend.py",
                  "cli/xray_web_viewer.py")

# Copied byte for byte: the GLSL sources, both web clients, the SDL stub.
_VERBATIM = tuple(f"viewer/gl/shaders/{name}" for name in (
    "points.fs", "points.vs", "points_f64.vs", "solid.fs", "solid.vs",
    "terrain.fs", "terrain.gs", "terrain.vs")) + (
    "viewer/client.html", "xray/client.html", "native/sdl2_stub.cpp")


def _texts(path):
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = []
    for pkg in ("point_cloud_viewer_tpu", "point_cloud_viewer_tpu_torch"):
        with open(os.path.join(root, pkg, path), "rb") as f:
            out.append(f.read().decode())
    return out


def _assert_unchanged_copy(path):
    original, copy = _texts(path)
    n = original.count("\n")
    note = f"\n\nCopy of point_cloud_viewer_tpu/{path}:1-{n}, unchanged.\n"
    assert copy.count(note) == 1
    assert original in (copy.replace(note, "\n"), copy.replace(note, ""))


@pytest.mark.parametrize("path", _VIEWER_COPIES)
def test_viewer_copies_are_their_originals(path):
    _assert_unchanged_copy(path)


@pytest.mark.parametrize("path", _VERBATIM)
def test_verbatim_files_are_byte_equal(path):
    original, copy = _texts(path)
    assert copy == original and len(copy) > 0


def _without_note(path, copy):
    """The copy with its docstring paragraph naming the source taken out."""
    start = copy.index(f"\n\nCopy of point_cloud_viewer_tpu/{path}:1-")
    end = copy.index('"""', start)
    return copy[:start] + "\n" + copy[end:]


# Each copy that differs, as (its text, the original's text) pairs: the copy
# with its note out and these reversed is the original.
_CHANGED_COPIES = {
    "viewer/gl/viewer.py": [
        ("                 device_cull: bool = True, device=\"cuda\") -> None:",
         "                 device_cull: bool = False) -> None:"),
        ("                         device_cull=device_cull, device=device)",
         "                         device_cull=device_cull)"),
        ("        self._raise_cull_error()\n        self.node_views.consume",
         "        self.node_views.consume")],
    "viewer/sdl_shell.py": [
        ("    device_cull: bool = True,\n    max_frames: Optional[int] = None,"
         "\n    device=\"cuda\",\n",
         "    device_cull: bool = False,\n"
         "    max_frames: Optional[int] = None,\n"),
        ("runs until Quit/Escape.\n    `device`: where the per-frame cull "
         "runs (with `device_cull`).\"\"\"",
         "runs until Quit/Escape.\"\"\""),
        ("            device_cull=device_cull, device=device,\n",
         "            device_cull=device_cull,\n")],
    "cli/points_web_viewer.py": [
        ("python -m point_cloud_viewer_tpu_torch.cli.points_web_viewer",
         "python -m point_cloud_viewer_tpu.cli.points_web_viewer")],
    "cli/export_ply.py": [
        ('patched on close).\n"""', 'patched on close)."""'),
        ("    client = PointCloudClient.from_locations(\n        "
         "args.locations, device_filter=args.device_filter, "
         "device=args.device\n    )\n",
         "    client = PointCloudClient.from_locations(args.locations)\n")],
}

# Blocks a changed copy adds, between these marker lines (both taken out
# with the block before the pairs above are reversed).
_ADDED_BLOCKS = {
    "cli/export_ply.py": ("    # Route flags of cli/query_points.py",
                          "    # End of the route flags.\n"),
}


@pytest.mark.parametrize("path", sorted(_CHANGED_COPIES))
def test_changed_copies_differ_only_where_named(path):
    """The GL viewer and the SDL shell: only the port's cull defaults,
    `device` and the cull-error check; the web viewer CLI: only the module
    path in its usage line; the PLY export CLI: only the query CLI's route
    flags (a marked block), passed to the client."""
    original, copy = _texts(path)
    text = _without_note(path, copy)
    if path in _ADDED_BLOCKS:
        begin, end = _ADDED_BLOCKS[path]
        i = text.index(begin)
        text = text[:i] + text[text.index(end, i) + len(end):]
    for mine, theirs in _CHANGED_COPIES[path]:
        assert mine in text, mine
        text = text.replace(mine, theirs)
    assert text == original


# --- the host tools: S2 building, export, upgrade, providers, traversal ----

# Unchanged copies (the S2 reader now takes io.node_io's DataProvider, as
# the original does).
_TOOL_COPIES = ("core/color.py", "io/factory.py", "octree/traversal.py",
                "s2_cells/splitter.py", "s2_cells/container.py",
                "cli/build_s2.py", "cli/upgrade_octree.py")


@pytest.mark.parametrize("path", _TOOL_COPIES)
def test_tool_copies_are_their_originals(path):
    _assert_unchanged_copy(path)


# Parts added to trimmed copies, as (path, first line, end): the text from
# the first line through `end` (None: the file's end) is the same in the
# copy and the original.
_ADDED_PARTS = [
    ("io/ply.py", "# Inverse of _PLY_DTYPES", "\n}\n"),
    ("io/ply.py", "class PlyStreamWriter:", None),
    ("io/node_io.py", "class DataProvider:", "\n\n\nclass "),
    ("octree/node_id.py", "    def root(cls)", "\n\n"),
    ("octree/node_id.py", "    def child(self", "\n\n"),
    ("core/attributes.py", "    def from_array(cls", "\n\n\n"),
    ("core/attributes.py", "_FROM_NP", "\n}\n"),
    ("core/points_batch.py", "    def data_types(self)", "\n\n"),
    # The public names the trimmed copies had left out.
    ("octree/node_id.py", "    def parent(self)", "node = node.parent()\n"),
    ("octree/node_id.py", "def child_index_from_cube(", "\n    )\n"),
    ("octree/node_id.py", "MAX_VECTOR_LEVEL = 21", "\n"),
    ("octree/node_id.py", "def pack_ids(", "\n    ]\n"),
    ("core/points_batch.py", "    def append(self", "\n\n"),
    ("core/points_batch.py", "    def get_attribute(self", ".get(name)\n"),
    ("core/attributes.py", "    @property\n    def size_bytes(self)", "\n\n"),
    ("io/node_io.py", "    def number_of_points(self", "\n\n\n"),
    ("native/__init__.py", "def disabled():", "\n\n\n"),
    ("native/__init__.py", "    if _disabled or os.environ.get(",
     "        return None\n"),
    ("native/__init__.py", "def encode_positions(", "\n\n\n"),
    ("native/pcv_native.cpp", "void encode_positions_u8(",
     "void decode_positions_u8("),
    ("ops/morton.py", "def morton_decode(", "\n\n\n"),
    ("ops/codec.py", "def encode_plain(", None),
    ("protos/pbwire.py", "    def float32(self", "\n\n"),
    ("protos/pbwire.py", "def iter_fields(buf", "\n\n\n"),
    ("protos/pbwire.py", "def parse_scalar_fields(", None),
    ("ops/tree_build.py", "_PAD_MIN = 1 << 16", "    return arr, n\n"),
    ("parallel/mesh.py", 'SHARD_AXIS = "shard"', "\n"),
]


@pytest.mark.parametrize("path,first,end", _ADDED_PARTS,
                         ids=[f"{p}:{f.split('(')[0].split()[-1]}"
                              for p, f, _ in _ADDED_PARTS])
def test_added_parts_are_their_originals(path, first, end):
    texts = []
    for text in _texts(path):
        i = text.index(first)
        texts.append(text[i:] if end is None else
                     text[i:text.index(end, i) + len(end)])
    assert texts[0] == texts[1] and len(texts[0]) > len(first)


# --- the added public names behave as the originals ----------------------


def _case_node_id_algebra(J, P):
    rng = np.random.default_rng(RNG_SEED + 40)
    levels = rng.integers(0, 22, 300)
    paths = [int(rng.integers(0, 8 ** int(l))) if l else 0 for l in levels]
    assert P.MAX_VECTOR_LEVEL == J.MAX_VECTOR_LEVEL == 21
    got = P.pack_ids(levels, np.array(paths, dtype=np.uint64))
    want = J.pack_ids(levels, np.array(paths, dtype=np.uint64))
    assert [n.value for n in got] == [n.value for n in want]
    for g, w in zip(got, want):
        assert str(g.parent()) == str(w.parent())
        assert g.child_index_in_parent() == w.child_index_in_parent()
        assert [a.value for a in g.ancestors()] == [
            a.value for a in w.ancestors()]


def _case_child_index_from_cube(J, P):
    from point_cloud_viewer_tpu.math.geometry import Cube as JCube
    from point_cloud_viewer_tpu_torch.math.geometry import Cube as PCube

    rng = np.random.default_rng(RNG_SEED + 41)
    mn, edge = rng.random(3) * 10.0 - 5.0, 8.0
    points = mn + rng.random((5000, 3)) * edge
    points[:500] = mn + edge / 2.0  # on the centre: not greater
    _same(P.child_index_from_cube(PCube(mn, edge), points),
          J.child_index_from_cube(JCube(mn, edge), points))


def _case_points_batch(J, P):
    from point_cloud_viewer_tpu.core.points_batch import PointsBatch as JB
    from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch as PB

    rng = np.random.default_rng(RNG_SEED + 42)
    parts = [(rng.random((n, 3)), rng.integers(0, 256, (n, 3), np.uint8),
              rng.random(n).astype(np.float32)) for n in (700, 0, 300)]
    got = want = None
    for pos, rgb, inten in parts:
        attrs = {"color": rgb, "intensity": inten}
        pb, jb = PB(pos, dict(attrs)), JB(pos, dict(attrs))
        got = pb if got is None else got.append(pb)
        want = jb if want is None else want.append(jb)
    _same(got.position, want.position)
    for name in ("color", "intensity", "absent"):
        g, w = got.get_attribute(name), want.get_attribute(name)
        assert (g is None) == (w is None)
        if w is not None:
            _same(g, w)


def _case_size_bytes(J, P):
    from point_cloud_viewer_tpu.core.attributes import AttributeDataType as JT
    from point_cloud_viewer_tpu_torch.core.attributes import (
        AttributeDataType as PT)

    assert [(t.name, t.size_bytes) for t in PT if t != PT.INVALID] == [
        (t.name, t.size_bytes) for t in JT if t != JT.INVALID]


def _case_number_of_points(J, P, tmp_path):
    from point_cloud_viewer_tpu.io import node_io as jio
    from point_cloud_viewer_tpu_torch.io import node_io as pio

    rng = np.random.default_rng(RNG_SEED + 43)
    n = 20_000
    batch = JaxBatch(position=rng.random((n, 3)) * 30.0, attributes={
        "color": rng.integers(0, 256, (n, 3), np.uint8)})
    jax_build(str(tmp_path / "rgb"), 0.01, batch, use_device=False)
    jax_build(str(tmp_path / "int"), 0.01, JaxBatch(
        position=batch.position,
        attributes={"intensity": rng.random(n).astype(np.float32)}),
        use_device=False)
    for sub in ("rgb", "int"):
        got = pio.OnDiskDataProvider(str(tmp_path / sub))
        want = jio.OnDiskDataProvider(str(tmp_path / sub))
        names = sorted(f.split(".")[0] for f in os.listdir(tmp_path / sub)
                       if f.endswith(".xyz"))
        assert [got.number_of_points(x) for x in names] == [
            want.number_of_points(x) for x in names]
        assert sum(got.number_of_points(x) for x in names) >= n
        with pytest.raises(pio.NodeNotFound):
            got.number_of_points("r77777")


def _case_morton_decode(J, P):
    from point_cloud_viewer_tpu.ops import morton as jm
    from point_cloud_viewer_tpu_torch.ops import morton as pm

    rng = np.random.default_rng(RNG_SEED + 44)
    codes = rng.integers(0, 2 ** 63, 20_000, dtype=np.uint64)
    for depth in (21, 10, 0):
        _same(pm.morton_decode(codes, depth), jm.morton_decode(codes, depth))
    cells = rng.integers(0, 2 ** 21, (1000, 3)).astype(np.uint32)
    _same(pm.morton_decode(pm.morton_encode(cells), 21), cells)


def _case_plain_codec(J, P):
    from point_cloud_viewer_tpu.ops import codec as jc
    from point_cloud_viewer_tpu_torch.ops import codec as pc

    pos = np.random.default_rng(RNG_SEED + 45).random((999, 3)) * 1e6
    for src in (pos, pos.astype(np.float32), pos.astype(">f8")):
        _same(pc.encode_plain(src), jc.encode_plain(src))
        enc = jc.encode_plain(src)
        _same(pc.decode_plain(enc), jc.decode_plain(enc))


def _case_pbwire(J, P):
    from point_cloud_viewer_tpu.protos import pbwire as jw
    from point_cloud_viewer_tpu_torch.protos import pbwire as pw

    def message(w):
        fw = w.FieldWriter()
        fw.varint(1, 7)
        for field, value in ((2, 0.5), (3, 0.0), (4, -1.25e-3), (5, 3e38),
                             (6, float("inf")), (2, 9.0)):
            fw.float32(field, value)
        fw.double(8, 2.5)
        fw.string(9, "s2")
        return fw.finish()

    raw = message(pw)
    assert raw == message(jw)
    for buf in (raw, _octree_meta_bytes(seed=RNG_SEED + 46)):
        assert list(pw.iter_fields(buf)) == list(jw.iter_fields(buf))
        assert pw.parse_scalar_fields(buf) == jw.parse_scalar_fields(buf)
    assert pw.parse_scalar_fields(raw)[2] == 9.0  # last one wins


def _case_shard_axis(J, P):
    from point_cloud_viewer_tpu.parallel import mesh as jmesh
    from point_cloud_viewer_tpu_torch.parallel import mesh as pmesh

    assert pmesh.SHARD_AXIS == jmesh.SHARD_AXIS == "shard"


_ADDED_NAMES = {
    "node_id algebra": _case_node_id_algebra,
    "child_index_from_cube": _case_child_index_from_cube,
    "PointsBatch.append/get_attribute": _case_points_batch,
    "AttributeDataType.size_bytes": _case_size_bytes,
    "OnDiskDataProvider.number_of_points": _case_number_of_points,
    "morton_decode": _case_morton_decode,
    "encode_plain/decode_plain": _case_plain_codec,
    "pbwire float32/iter_fields/parse_scalar_fields": _case_pbwire,
    "SHARD_AXIS": _case_shard_axis,
}


@pytest.mark.parametrize("case", sorted(_ADDED_NAMES))
def test_added_public_names_behave_as_jax(case, tmp_path):
    """Each public name added to a trimmed copy against the original on
    seeded inputs (the native encode is in NATIVE_NAMES, the padded
    entries and the culling blocks in tests/test_torch_api.py)."""
    import inspect

    from point_cloud_viewer_tpu.octree import node_id as J
    from point_cloud_viewer_tpu_torch.octree import node_id as P

    fn = _ADDED_NAMES[case]
    if "tmp_path" in inspect.signature(fn).parameters:
        fn(J, P, tmp_path)
    else:
        fn(J, P)
