"""The port's host-only x-ray tools against the JAX package's: partial
builds merged (xray.merge, cli.merge_xray_quadtrees), hole inpainting
(xray.inpaint, cli.inpaint_xray_quadtree; the cases of tests/test_inpaint.py)
and the v2 -> v3 meta upgrade (cli.upgrade_xray_quadtree).  Each tool runs
on its own copy of the same input; the output directories are compared
byte for byte and what the tools print line for line.  Tolerance: none.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from point_cloud_viewer_tpu.xray.quadtree import QuadNodeId
from tests.conftest import assert_dirs_byte_equal


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tile(color, size=32):
    img = np.zeros((size, size, 4), dtype=np.uint8)
    img[:, :, :3] = color
    img[:, :, 3] = 255
    return img


def _save(directory, name, img):
    Image.fromarray(img, "RGBA").save(os.path.join(directory, f"{name}.png"))


def _twins(tmp_path, source):
    """Two copies of `source`: (JAX's, the port's)."""
    out = []
    for who in ("jax", "port"):
        d = str(tmp_path / who)
        shutil.copytree(source, d)
        out.append(d)
    return out


# --- merge -----------------------------------------------------------------


@pytest.fixture(scope="module")
def cloud_dir(tmp_path_factory):
    """tests/test_xray.py's cloud, built by the JAX package."""
    from point_cloud_viewer_tpu.core.points_batch import PointsBatch
    from point_cloud_viewer_tpu.octree.builder import build_octree

    rng = np.random.default_rng(17)
    n = 60_000
    batch = PointsBatch(
        position=rng.random((n, 3)) * np.array([4.0, 4.0, 1.0]),
        attributes={"color": rng.integers(0, 256, (n, 3), dtype=np.uint8)})
    out = str(tmp_path_factory.mktemp("cloud"))
    build_octree(out, 0.001, batch)
    return out


def _port_build(cloud_dir, out, root="r"):
    from point_cloud_viewer_tpu_torch.query.client import PointCloudClient
    from point_cloud_viewer_tpu_torch.xray.build import (
        XrayParameters, build_xray_quadtree)
    from point_cloud_viewer_tpu_torch.xray.quadtree import (
        QuadNodeId as PortId)

    client = PointCloudClient.from_locations([cloud_dir], num_threads=1,
                                             device="cpu")
    return build_xray_quadtree(
        "xray", XrayParameters(out, client, tile_size_px=64,
                               pixel_size_m=0.05,
                               root_node_id=PortId.from_str(root)),
        strategy_kwargs={"device": "cpu"}, num_threads=2)


@pytest.mark.parametrize("route", ["library", "cli"])
def test_partial_builds_merge_as_jax(cloud_dir, tmp_path, route, capsys):
    """tests/test_xray.py::test_partial_build_and_merge in the port: the four
    level-1 quadrants built on CPU tensors and merged give the full build's
    node set, and the merged directory equals the JAX package's merge of
    the same parts byte for byte."""
    from point_cloud_viewer_tpu.cli.merge_xray_quadtrees import main as jcli
    from point_cloud_viewer_tpu.xray.merge import merge_xray_quadtrees as jm
    from point_cloud_viewer_tpu_torch.cli.merge_xray_quadtrees import main
    from point_cloud_viewer_tpu_torch.xray.merge import merge_xray_quadtrees

    parts = []
    for q in range(4):
        parts.append(str(tmp_path / f"part{q}"))
        _port_build(cloud_dir, parts[-1], root=f"r{q}")
    full = _port_build(cloud_dir, str(tmp_path / "full"))
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    if route == "library":
        jmeta = jm(want, parts, (10, 20, 30, 255))
        meta = merge_xray_quadtrees(got, parts, (10, 20, 30, 255))
        assert {(n.level, n.index) for n in meta.nodes} == {
            (n.level, n.index) for n in jmeta.nodes}
    else:
        said = []
        for cli, out in ((jcli, want), (main, got)):
            assert cli([*parts, "--output_directory", out,
                        "--tile_background_color", "10,20,30,255"]) == 0
            said.append(capsys.readouterr().out.replace(out, "OUT"))
        assert said[0] == said[1]
    assert_dirs_byte_equal(want, got, context=f"merge {route}")
    from point_cloud_viewer_tpu_torch.xray.meta import XrayMeta

    merged = XrayMeta.from_directory(got)
    assert {(n.level, n.index) for n in merged.nodes} == {
        (n.level, n.index) for n in full.nodes}


def test_merge_refusals_match_jax(cloud_dir, tmp_path):
    """Parts whose roots lie at different levels, and no parts at all,
    raise the same ValueError in both packages."""
    from point_cloud_viewer_tpu.xray.merge import merge_xray_quadtrees as jm
    from point_cloud_viewer_tpu_torch.xray.merge import merge_xray_quadtrees

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _port_build(cloud_dir, a, root="r0")
    _port_build(cloud_dir, b)
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    for inputs in ([a, b], [empty]):
        with pytest.raises(ValueError) as e_port:
            merge_xray_quadtrees(str(tmp_path / "p"), inputs)
        with pytest.raises(ValueError) as e_jax:
            jm(str(tmp_path / "j"), inputs)
        assert str(e_port.value) == str(e_jax.value)


# --- inpaint ---------------------------------------------------------------


def _holes_image(size=64):
    img = _tile((100, 150, 200), size=size)
    img[10:14, 10:14] = 0
    img[30:54, 30:54] = 0
    return img


def _border_image():
    img = np.zeros((32, 32, 4), dtype=np.uint8)
    img[8:24, 8:24] = [50, 60, 70, 255]
    return img


def _stripes_image():
    h = w = 96
    img = np.zeros((h, w, 4), dtype=np.uint8)
    img[..., 3] = 255
    stripe = ((np.arange(w) // 6) % 2).astype(np.uint8)
    img[:, :, 0] = np.where(stripe, 220, 30)[None, :]
    img[:, :, 1] = np.where(stripe, 60, 180)[None, :]
    img[:, :, 2] = 90
    img[40:56, 40:56] = 0
    return img


@pytest.mark.parametrize("case", ["holes", "border", "stripes",
                                  "diffusion", "close_alpha"])
def test_inpaint_functions_match_jax(case):
    """inpaint_image, patchmatch_fill, diffusion_fill and _close_alpha on
    tests/test_inpaint.py's images: equal arrays."""
    from point_cloud_viewer_tpu.xray import inpaint as J
    from point_cloud_viewer_tpu_torch.xray import inpaint as P

    if case == "holes":
        outs = [m.inpaint_image(_holes_image(), distance_px=3) for m in (P, J)]
    elif case == "border":
        outs = [m.inpaint_image(_border_image(), distance_px=2)
                for m in (P, J)]
    elif case == "close_alpha":
        outs = [m._close_alpha(_holes_image()[:, :, 3], 3) for m in (P, J)]
    else:
        img = _stripes_image()
        valid = img[:, :, 3] > 0
        fill = np.ones_like(valid)
        outs = [(m.patchmatch_fill(img, fill, valid) if case == "stripes"
                 else m.diffusion_fill(img, fill, valid, iterations=40))
                for m in (P, J)]
    assert outs[0].dtype == outs[1].dtype
    np.testing.assert_array_equal(outs[0], outs[1])


def test_perform_inpainting_across_tiles_matches_jax(tmp_path):
    from point_cloud_viewer_tpu.xray.inpaint import perform_inpainting as jp
    from point_cloud_viewer_tpu_torch.xray.inpaint import perform_inpainting
    from point_cloud_viewer_tpu_torch.xray.quadtree import (
        QuadNodeId as PortId)

    src = str(tmp_path / "src")
    os.makedirs(src)
    colors = {0: (200, 0, 0), 1: (0, 200, 0), 2: (0, 0, 200), 3: (200, 200, 0)}
    for i, color in colors.items():
        img = _tile(color)
        if i == 0:
            img[14:18, 28:32] = 0
        _save(src, str(QuadNodeId(1, i)), img)
    want, got = _twins(tmp_path, src)
    jp(want, 3, [QuadNodeId(1, i) for i in range(4)], num_threads=2)
    perform_inpainting(got, 3, [PortId(1, i) for i in range(4)],
                       num_threads=2)
    assert_dirs_byte_equal(want, got, context="perform_inpainting")


def _meta_bytes(root_level, root_index, leaves, edge, deepest, tile_size=32,
                version=3):
    from point_cloud_viewer_tpu.protos.xray_meta import (
        RectProto, XrayMetaProto, XrayNodeIdProto)

    return XrayMetaProto(
        version=version,
        bounding_rect=RectProto(min=(0.0, 0.0), edge_length=edge),
        deepest_level=deepest, tile_size=tile_size,
        nodes=[XrayNodeIdProto(root_level, root_index)]
        + [XrayNodeIdProto(n.level, n.index) for n in leaves]).encode()


def _write(path, data):
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("case", ["root", "partial_with_neighbors",
                                  "partial_without_neighbors"])
def test_inpaint_cli_matches_jax(tmp_path, capsys, case):
    """tests/test_inpaint.py's three CLI cases (a root tile in place; the
    r0 partial quadtree with and without r2's border leaves imported,
    written to another directory): equal output directories, equal
    stdout and stderr."""
    from point_cloud_viewer_tpu.cli.inpaint_xray_quadtree import main as jcli
    from point_cloud_viewer_tpu_torch.cli.inpaint_xray_quadtree import main

    src = str(tmp_path / "src")
    os.makedirs(src)
    if case == "root":
        img = _tile((10, 20, 30))
        img[5:8, 5:8] = 0
        _save(src, "r", img)
        _write(os.path.join(src, "meta.pb"), _meta_bytes(0, 0, [], 32.0, 0))
        flags = ["--inpaint_distance", "3"]
    else:
        r0, r2 = QuadNodeId.from_str("r0"), QuadNodeId.from_str("r2")
        a_leaves = [r0.child(i) for i in range(4)]
        for nid in a_leaves:
            img = _tile((200, 30, 30))
            if str(nid) == "r02":
                img[8:24, 30:32] = 0
            _save(src, str(nid), img)
        _write(os.path.join(src, "meta0.pb"),
               _meta_bytes(1, 0, a_leaves, 32.0, 2))
        if case == "partial_with_neighbors":
            b_leaves = [r2.child(i) for i in range(4)]
            _write(os.path.join(src, "meta2.pb"),
                   _meta_bytes(1, 2, b_leaves, 32.0, 2))
            for nid in b_leaves:
                if nid.to_spatial().x == 2:
                    _save(src, str(nid), _tile((30, 200, 30)))
        flags = ["--root_node_id", "r0", "--inpaint_distance_px", "3",
                 "--num_threads", "2"]
    said = []
    outs = []
    for who, cli in (("jax", jcli), ("port", main)):
        d = str(tmp_path / who)
        shutil.copytree(src, d)
        extra = [] if case == "root" else ["--output_directory", d + "_out"]
        assert cli([d, *extra, *flags]) == 0
        got = capsys.readouterr()
        said.append((got.out.replace(d, "DIR"), got.err.replace(d, "DIR")))
        outs.append(d if case == "root" else d + "_out")
    assert said[0] == said[1]
    assert_dirs_byte_equal(*outs, context=f"inpaint {case}")
    if case == "root":
        out = np.asarray(Image.open(os.path.join(outs[1], "r.png")))
        assert (out[5:8, 5:8, 3] == 255).all()


# --- upgrade ---------------------------------------------------------------


@pytest.mark.parametrize("version", [2, 3])
def test_upgrade_cli_matches_jax(tmp_path, capsys, version):
    """A v2 meta.pb is rewritten at v3, a v3 one left as it is: the same
    bytes and the same message in both packages."""
    from point_cloud_viewer_tpu.cli.upgrade_xray_quadtree import main as jcli
    from point_cloud_viewer_tpu_torch.cli.upgrade_xray_quadtree import main

    src = str(tmp_path / "src")
    os.makedirs(src)
    leaves = [QuadNodeId(2, i) for i in (0, 5, 15)]
    _write(os.path.join(src, "meta.pb"),
           _meta_bytes(0, 0, leaves, 12.5, 2, tile_size=256, version=version))
    want, got = _twins(tmp_path, src)
    said = []
    for cli, d in ((jcli, want), (main, got)):
        assert cli([d]) == 0
        said.append(capsys.readouterr().out.replace(d, "DIR"))
    assert said[0] == said[1]
    assert_dirs_byte_equal(want, got, context=f"upgrade v{version}")
    from point_cloud_viewer_tpu_torch.protos.xray_meta import XrayMetaProto

    with open(os.path.join(got, "meta.pb"), "rb") as f:
        assert XrayMetaProto.decode(f.read()).version == 3
