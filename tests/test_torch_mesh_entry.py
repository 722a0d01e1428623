"""The port's mesh entry points (point_cloud_viewer_tpu_torch/cli/
build_octree.py --mesh, entry.py) on CPU meshes against the JAX package
on its virtual CPU devices: the CLI's octree byte-identical to the JAX
CLI's, the geodesic query counts over a mesh-built cloud equal to the
JAX check's, entry() to the JAX package's cull tolerance, and the dry run
on CPU shards."""

import os

import numpy as np
import pytest
import torch

from point_cloud_viewer_tpu.core.points_batch import PointsBatch
from point_cloud_viewer_tpu.octree.builder import build_octree as jax_build
from point_cloud_viewer_tpu_torch.cli.build_octree import main as cli_main
from point_cloud_viewer_tpu_torch.octree import builder as B
from point_cloud_viewer_tpu_torch.parallel.mesh import make_mesh
from tests.conftest import assert_dirs_byte_equal, cpu_mesh
from tests.test_torch_octree_build import _write_tiny_ply


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests run beside other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("flags", [
    ["--mesh", "2"],
    ["--mesh", "2", "--no-use_device"],
    ["--mesh", "4", "--device", "cpu"],
])
def test_cli_mesh_matches_jax_cli(tmp_path, flags, capsys):
    """The three flag sets the refusal test used to exit on, now built: the
    port on CPU shards (--device cpu, as there is no card here) against
    the JAX CLI on its virtual devices."""
    from point_cloud_viewer_tpu.cli.build_octree import main as jax_cli

    ply = str(tmp_path / "tiny.ply")
    _write_tiny_ply(ply, 20_000, seed=9)
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    port_flags = flags if "--device" in flags else [*flags, "--device",
                                                    "cpu"]
    phases = {}
    assert cli_main([ply, "--output_directory", port, *port_flags],
                    phase_times=phases) == 0
    jax_flags = [f for f in flags if f != "--no-use_device"]
    jax_flags = jax_flags[:2]  # --mesh N; the JAX CLI has no --device
    assert jax_cli([ply, "--output_directory", ref, *jax_flags]) == 0
    assert_dirs_byte_equal(ref, port, context=f"port CLI {port_flags}")
    assert "sharded sort+derive" in phases and "read ply" in phases
    assert "Built octree with 20000 points" in capsys.readouterr().out


def test_cli_mesh_needs_a_card_unless_the_cpu_is_asked_for(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ply = str(tmp_path / "tiny.ply")
    _write_tiny_ply(ply, 10, seed=1)
    with pytest.raises(RuntimeError, match="is_available"):
        cli_main([ply, "--output_directory", str(tmp_path / "o"), "--mesh",
                  "2"])
    assert not os.path.exists(tmp_path / "o")


def test_cli_mesh_with_streaming_still_exits(tmp_path, capsys):
    ply = str(tmp_path / "tiny.ply")
    _write_tiny_ply(ply, 10, seed=1)
    with pytest.raises(SystemExit) as exc:
        cli_main([ply, "--output_directory", str(tmp_path / "o"), "--mesh",
                  "2", "--streaming", "--device", "cpu"])
    assert exc.value.code != 0
    assert "not supported with --streaming" in capsys.readouterr().err


def _earth_batch(n, seed):
    """test_sharded_octree.py:140-150: a 200 x 200 x 20 m patch near
    37.4 N 122.1 W in ECEF, the point index in its color."""
    from point_cloud_viewer_tpu_torch.math.wgs84 import (
        local_frame_from_lat_lng,
    )

    rng = np.random.default_rng(seed)
    local = (rng.random((n, 3)) - 0.5) * np.array([200.0, 200.0, 20.0])
    ecef = local_frame_from_lat_lng(37.4, -122.1).inverse().transform_points(
        local)
    idx = np.arange(n, dtype=np.uint32)
    color = np.stack([(idx >> 16) & 0xFF, (idx >> 8) & 0xFF, idx & 0xFF],
                     axis=1).astype(np.uint8)
    return ecef, PointsBatch(position=ecef, attributes={"color": color})


def test_mesh_built_cloud_geodesic_queries_match_jax(tmp_path):
    """The dry run's query clause (__graft_entry__._geodesic_query_check)
    over a mesh-built Earth-surface cloud: the port's check, its client
    filtering on the CPU, gives the JAX check's counts on the JAX builds."""
    import __graft_entry__ as ge
    from point_cloud_viewer_tpu_torch.entry import _geodesic_query_check

    ecef, batch = _earth_batch(60_000, seed=8)
    dirs = {k: str(tmp_path / k) for k in ("mesh", "single", "jmesh",
                                           "jhost")}
    B.build_octree(dirs["mesh"], 0.01, batch,
                   mesh=make_mesh(8, device="cpu"))
    B.build_octree(dirs["single"], 0.01, batch, device="cpu")
    jax_build(dirs["jmesh"], 0.01, batch, mesh=cpu_mesh(8))
    jax_build(dirs["jhost"], 0.01, batch)
    got = _geodesic_query_check(dirs["mesh"], dirs["single"], ecef,
                                torch.device("cpu"))
    want = ge._geodesic_query_check(dirs["jmesh"], dirs["jhost"], ecef)
    assert got == want and min(got) > 0


def test_entry_matches_jax_entry():
    """entry() against __graft_entry__.entry() on the CPU, to the JAX
    package's own tolerance between its lax step and its Pallas kernel
    (tests/test_torch_cull.py)."""
    import __graft_entry__ as ge
    from point_cloud_viewer_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    j_fn, j_args = ge.entry()
    for a, b in zip(args, j_args):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    order, sizes, visible = (x.numpy() for x in fn(*args))
    j_order, j_sizes, j_visible = (np.asarray(x) for x in j_fn(*j_args))
    np.testing.assert_array_equal(visible, j_visible)
    assert 0 < visible.sum() < len(visible)
    np.testing.assert_allclose(sizes[visible], j_sizes[visible], rtol=1e-5,
                               atol=1e-6)
    pr = np.where(j_visible, j_sizes, -np.inf)
    np.testing.assert_allclose(pr[order], pr[j_order], rtol=1e-5, atol=1e-6)


def test_entry_asks_for_the_card_by_default(monkeypatch):
    from point_cloud_viewer_tpu_torch.entry import dryrun_multichip, entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        entry()
    with pytest.raises(RuntimeError, match="is_available"):
        dryrun_multichip(2)


def test_dryrun_multichip_on_cpu_shards(monkeypatch, capsys):
    """dryrun_multichip(4, device="cpu") with its build cut to 100,003
    points: the stats step, the skewed retry and the mesh build
    byte-equal to one device, with the geodesic queries."""
    from point_cloud_viewer_tpu_torch import entry as E

    monkeypatch.setattr(E, "BUILD_POINTS", 100_003)
    summary = E.dryrun_multichip(4, device="cpu")
    assert summary["mesh"] == [f"cpu:{i}" for i in range(4)]
    assert summary["skew_attempts"] >= 2
    assert summary["stats_valid"] + summary["stats_dropped"] == 4 * 256
    assert sum(summary["shard_points"]) == 100_003
    assert summary["files"] > 1 and min(summary["cell_union_points"],
                                        summary["web_mercator_points"]) > 0
    assert "dryrun_multichip(4)" in capsys.readouterr().out
