"""The PyTorch port's in-core device build (point_cloud_viewer_tpu_torch/
octree/builder.py and cli/build_octree.py) against the JAX package's
builds on the CPU: the on-disk octree must be byte-identical to both the
JAX device build (`use_device=True`) and the JAX host build."""

import os

import numpy as np
import pytest

from point_cloud_viewer_tpu.core.points_batch import PointsBatch
from point_cloud_viewer_tpu.octree.builder import build_octree as jax_build
from point_cloud_viewer_tpu.octree.octree import Octree
from point_cloud_viewer_tpu_torch.cli.build_octree import main as cli_main
from point_cloud_viewer_tpu_torch.octree.builder import build_octree
from point_cloud_viewer_tpu_torch.ops import leaf_levels_cuda as K6
from point_cloud_viewer_tpu_torch.ops import level_cuda as LC
from point_cloud_viewer_tpu_torch.ops import scan_cuda as SC
from tests.conftest import assert_dirs_byte_equal
from tests.test_streaming_build import _one_point_leaf_batch


def _three_way(tmp_path, batch, resolution, phase_times=None):
    """Port (CPU) vs JAX device build vs JAX host build."""
    port = str(tmp_path / "port")
    jax_dev = str(tmp_path / "jax_device")
    host = str(tmp_path / "host")
    result = build_octree(port, resolution, batch, use_device=True,
                          device="cpu", phase_times=phase_times)
    jax_build(jax_dev, resolution, batch, use_device=True)
    jax_build(host, resolution, batch)
    assert_dirs_byte_equal(jax_dev, port, context="port vs JAX device")
    assert_dirs_byte_equal(host, port, context="port vs JAX host")
    return port, result


def test_build_150k_color_intensity_matches_jax(tmp_path):
    """As test_sharded_octree.py:58-76: 150k points, color + intensity."""
    rng = np.random.default_rng(7)
    n = 150_000
    batch = PointsBatch(
        position=rng.random((n, 3)) * 12.0,
        attributes={
            "color": rng.integers(0, 255, (n, 3), dtype=np.uint8),
            "intensity": rng.random(n).astype(np.float32),
        },
    )
    phases = {}
    _, result = _three_way(tmp_path, batch, 0.001, phases)
    assert result.num_points == n
    assert {"quantize+morton", "device core", "group levels",
            "encode+write"} <= set(phases)


def test_build_clustered_deep_leaves_matches_jax(tmp_path):
    """A dense cluster past MAX_POINTS_PER_NODE splits several levels down;
    the uniform points around it do not."""
    rng = np.random.default_rng(21)
    uniform = rng.random((30_000, 3)) * 50.0
    cluster = 20.0 + rng.normal(0.0, 0.05, (220_000, 3))
    batch = PointsBatch(position=np.concatenate([uniform, cluster]),
                        attributes={})
    port, result = _three_way(tmp_path, batch, 0.001)
    assert max(node.level for node, _ in result.nodes) >= 3


def test_build_single_point_matches_jax(tmp_path):
    batch = PointsBatch(
        position=np.array([[1.0, 2.0, 3.0]]),
        attributes={"color": np.array([[9, 8, 7]], dtype=np.uint8)},
    )
    _three_way(tmp_path, batch, 0.01)


def test_build_one_point_leaves_matches_jax(tmp_path):
    """The 1-point-leaf batch (as test_octree_build.py:331-350): meta must
    record the promoted-away leaves as empty nodes (the extras)."""
    port, _ = _three_way(tmp_path, _one_point_leaf_batch(), 0.01)
    assert (Octree.from_directory(port).num_points == 0).sum() >= 1


def test_build_extras_overflow_route_matches_jax(tmp_path, monkeypatch):
    """More 1-point leaves than extras_cap: the build falls back to the
    classic (idx, final, leaf) exchange and writes the same bytes."""
    from point_cloud_viewer_tpu_torch.ops import tree_build

    grouped = tree_build.build_tree_device_codes_grouped
    caps = []

    def tiny_cap(*args, **kwargs):
        kwargs["extras_cap"] = 1
        out = grouped(*args, **kwargs)
        caps.append(int(out.extras_total))
        return out

    monkeypatch.setattr(tree_build, "build_tree_device_codes_grouped",
                        tiny_cap)
    _three_way(tmp_path, _one_point_leaf_batch(), 0.01)
    assert caps and caps[0] > 1


def test_build_empty_matches_jax(tmp_path):
    batch = PointsBatch(position=np.zeros((0, 3)), attributes={})
    _three_way(tmp_path, batch, 0.01)
    assert os.listdir(tmp_path / "port") == ["meta.pb"]


def test_build_reads_back_and_answers_full_box_query(tmp_path):
    """The port's output opens with Octree and a query over the whole
    bounding box (grown by twice the resolution, as decoded positions lie
    within it of the true ones) streams back every point."""
    from point_cloud_viewer_tpu.math.geometry import Aabb
    from point_cloud_viewer_tpu.query.client import PointCloudClient
    from point_cloud_viewer_tpu.query.point_query import PointQuery

    rng = np.random.default_rng(12)
    n = 120_000
    batch = PointsBatch(
        position=np.concatenate([rng.random((n // 2, 3)) * 30.0,
                                 9.0 + rng.normal(0.0, 0.2, (n // 2, 3))]),
        attributes={"intensity": rng.random(n).astype(np.float32)},
    )
    out = str(tmp_path / "o")
    build_octree(out, 0.001, batch, device="cpu")
    octree = Octree.from_directory(out)
    box = octree.bounding_box
    query = PointQuery(location=Aabb(box.mins - 0.002, box.maxs + 0.002))
    got = sum(len(b) for b in PointCloudClient([octree]).stream(query))
    assert got == n


def test_build_leaves_launch_counters_at_zero_on_cpu(tmp_path):
    rng = np.random.default_rng(3)
    batch = PointsBatch(position=rng.random((5_000, 3)), attributes={})
    wrappers = (SC.scan_1d, LC.seg_start_pass, LC.leaf_update_pass,
                LC.promote_pass, LC.promote_stage, K6.leaf_stage,
                K6.leaf_levels)
    before = [w.launches for w in wrappers]
    build_octree(str(tmp_path / "o"), 0.001, batch, use_device=True,
                 device="cpu")
    assert [w.launches for w in wrappers] == before


def test_unported_paths_raise(tmp_path):
    batch = PointsBatch(position=np.random.default_rng(0).random((10, 3)),
                        attributes={})
    out = str(tmp_path / "o")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_octree(out, 0.001, batch, use_device=False, device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_octree(out, 0.001, batch, use_device=True, mesh=object(),
                     device="cpu")
    far = PointsBatch(position=np.array([[0.0, 0.0, 0.0], [1e7, 1e7, 1e7]]),
                      attributes={})
    with pytest.raises(NotImplementedError, match="deep build"):
        build_octree(out, 0.001, far, use_device=True, device="cpu")


def _write_tiny_ply(path, n, seed):
    rng = np.random.default_rng(seed)
    rows = np.empty(n, dtype=[("x", "<f8"), ("y", "<f8"), ("z", "<f8"),
                              ("red", "u1"), ("green", "u1"), ("blue", "u1"),
                              ("intensity", "<f4")])
    pos = rng.random((n, 3)) * 10.0
    rows["x"], rows["y"], rows["z"] = pos.T
    rgb = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    rows["red"], rows["green"], rows["blue"] = rgb.T
    rows["intensity"] = rng.random(n, dtype=np.float32)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property double x\nproperty double y\nproperty double z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "property float intensity\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rows.tofile(f)


def test_cli_matches_jax_cli(tmp_path, capsys):
    from point_cloud_viewer_tpu.cli.build_octree import main as jax_cli

    ply = str(tmp_path / "tiny.ply")
    _write_tiny_ply(ply, 2_000, seed=8)
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    phases = {}
    assert cli_main([ply, "--output_directory", port, "--use_device",
                     "--device", "cpu"], phase_times=phases) == 0
    assert jax_cli([ply, "--output_directory", ref, "--use_device"]) == 0
    assert_dirs_byte_equal(ref, port, context="port CLI vs JAX CLI")
    assert "read ply" in phases and "device core" in phases
    assert "Built octree with 2000 points" in capsys.readouterr().out


@pytest.mark.parametrize(
    "flags", [["--streaming"], ["--mesh", "2"], ["--no-use_device"]])
def test_cli_unported_routes_exit(tmp_path, flags, capsys):
    ply = str(tmp_path / "tiny.ply")
    _write_tiny_ply(ply, 10, seed=1)
    args = [ply, "--output_directory", str(tmp_path / "o"), *flags]
    if "--streaming" in flags:  # ported, but not without a device
        args.append("--no-use_device")
    with pytest.raises(SystemExit) as exc:
        cli_main(args)
    assert exc.value.code != 0
    assert "not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize("positional", [False, True])
def test_build_with_bounding_box_matches_jax(tmp_path, positional):
    """A box larger than the points roots the octree at its cube and goes
    into meta.pb, as in the JAX package; `bounding_box` sits after
    `attributes` in both signatures."""
    from point_cloud_viewer_tpu.math.geometry import Aabb as JaxAabb
    from point_cloud_viewer_tpu_torch.math.geometry import Aabb

    rng = np.random.default_rng(17)
    batch = PointsBatch(
        position=np.concatenate([rng.random((40_000, 3)) * 5.0 + 2.0,
                                 3.0 + rng.normal(0.0, 0.02, (20_000, 3))]),
        attributes={"intensity": rng.random(60_000).astype(np.float32)},
    )
    lo, hi = [-10.0, -4.0, 0.5], [30.0, 12.0, 9.0]
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    if positional:
        result = build_octree(port, 0.001, batch, None, Aabb(lo, hi),
                              device="cpu")
        jax_build(ref, 0.001, batch, None, JaxAabb(lo, hi), False, True)
    else:
        result = build_octree(port, 0.001, batch, bounding_box=Aabb(lo, hi),
                              device="cpu")
        jax_build(ref, 0.001, batch, bounding_box=JaxAabb(lo, hi),
                  use_device=True)
    assert_dirs_byte_equal(ref, port, context="port vs JAX, bounding_box")
    octree = Octree.from_directory(port)
    np.testing.assert_array_equal(octree.bounding_box.mins, lo)
    np.testing.assert_array_equal(octree.bounding_box.maxs, hi)
    assert result.root_cube.edge_length == 40.0
    assert result.num_points == len(batch)


def test_build_progress_prints_jax_phase_lines(tmp_path, capsys):
    import re

    rng = np.random.default_rng(4)
    batch = PointsBatch(position=rng.random((3_000, 3)) * 8.0,
                        attributes={})
    said = []
    for build, kwargs in ((build_octree, {"device": "cpu"}),
                          (jax_build, {"use_device": True})):
        build(str(tmp_path / build.__module__), 0.001, batch, progress=True,
              **kwargs)
        out = capsys.readouterr()
        said.append(re.sub(r"\d+\.\d{3}s", "X.XXXs", out.err))
    assert said[0] == said[1]
    assert said[0] == "".join(
        f"build_octree: {p}: X.XXXs\n" for p in
        ("quantize+morton", "device core", "group levels", "encode+write"))
