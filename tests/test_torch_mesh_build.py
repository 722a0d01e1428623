"""The port's multi-device build (point_cloud_viewer_tpu_torch/octree/
builder.py with `mesh`, cli/build_octree.py --mesh, entry.py) on CPU
meshes against the JAX package's mesh build on its virtual CPU devices:
the on-disk octree must be byte-identical to the JAX mesh build and to
the port's single-device build, with the same points a shard.  The CLI,
the geodesic queries and the entry points are in test_torch_mesh_entry.py."""

import numpy as np
import pytest
import torch

from point_cloud_viewer_tpu.core.constants import MAX_POINTS_PER_NODE
from point_cloud_viewer_tpu.core.points_batch import PointsBatch
from point_cloud_viewer_tpu.octree.builder import build_octree as jax_build
from point_cloud_viewer_tpu_torch.math.geometry import Aabb
from point_cloud_viewer_tpu_torch.octree import builder as B
from point_cloud_viewer_tpu_torch.parallel.mesh import make_mesh
from tests.conftest import assert_dirs_byte_equal, cpu_mesh

PLANET = 6.4e6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests run beside other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(n, seed, extent=30.0):
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.random((n // 2, 3)) * extent,
                          extent / 3 + rng.normal(0.0, 0.05,
                                                  (n - n // 2, 3))])
    return PointsBatch(position=pos, attributes={
        "color": rng.integers(0, 256, (n, 3), dtype=np.uint8),
        "intensity": rng.random(n).astype(np.float32),
    })


@pytest.mark.parametrize("n_shards", [1, 2, 3, 5, 8])
def test_mesh_build_matches_jax_mesh_build(tmp_path, n_shards):
    """As test_sharded_octree.py:94-111, with color, intensity and a dense
    knot (subtrees below level B on several shards)."""
    batch = _batch(60_000, seed=500 + n_shards)
    port, ref, single = (str(tmp_path / d) for d in ("port", "jax",
                                                     "single"))
    phases = {}
    result = B.build_octree(port, 0.01, batch,
                            mesh=make_mesh(n_shards, device="cpu"),
                            phase_times=phases)
    want = jax_build(ref, 0.01, batch, mesh=cpu_mesh(n_shards))
    B.build_octree(single, 0.01, batch, device="cpu")
    assert_dirs_byte_equal(ref, port, context=f"port mesh({n_shards})")
    assert_dirs_byte_equal(single, port, context="mesh vs one device")
    assert result.shard_points == want.shard_points
    assert sum(result.shard_points) == len(batch) == result.num_points
    assert set(phases) == {"quantize+morton", "sharded sort+derive",
                           "group+encode+write", "top"}


def test_mesh_build_reads_neither_use_device_nor_device(tmp_path,
                                                        monkeypatch):
    """With a mesh the build runs on the mesh's devices: the default
    device="cuda" is not resolved (no card here), use_device=False does
    not send it to the host route, and the f32 stats step is never taken
    (test_sharded_octree.py:114-132)."""
    from point_cloud_viewer_tpu_torch.parallel import sharded_build

    def boom(*a, **k):
        raise AssertionError("f32 stats path reached from the exact build")

    monkeypatch.setattr(sharded_build, "_local_step", boom)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = _batch(30_000, seed=123, extent=20.0)
    ref = str(tmp_path / "jax")
    jax_build(ref, 0.01, batch, mesh=cpu_mesh(4))
    for use_device in (True, False):
        out = str(tmp_path / f"o{use_device}")
        phases = {}
        result = B.build_octree(out, 0.01, batch, use_device=use_device,
                                mesh=make_mesh(4, device="cpu"),
                                phase_times=phases)
        assert "sharded sort+derive" in phases
        assert result.num_points == len(batch)
        assert_dirs_byte_equal(ref, out, context=f"use_device={use_device}")


@pytest.mark.parametrize("case", ["empty", "one point", "one level"])
def test_mesh_build_small_trees_match_jax(tmp_path, case):
    """No points; one point; a tree of a root and one level (depth cap 1,
    which takes the sort route on the mesh's first device)."""
    rng = np.random.default_rng(5)
    position = {"empty": np.zeros((0, 3)),
                "one point": np.array([[1.0, 2.0, 3.0]]),
                "one level": rng.random((500, 3)) * 0.015}[case]
    batch = PointsBatch(position=position, attributes={})
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    result = B.build_octree(port, 0.01, batch,
                            mesh=make_mesh(3, device="cpu"))
    jax_build(ref, 0.01, batch, mesh=cpu_mesh(3))
    assert_dirs_byte_equal(ref, port, context=case)
    if case == "one level":
        assert result.depth_cap == 1 and result.shard_points is None


def _three_fat_cells():
    """test_deep_build.py:166-189: three fat level-21 cells."""
    edge21 = PLANET / (1 << 21)
    rng = np.random.default_rng(17)
    per = MAX_POINTS_PER_NODE + 10_000
    clusters = [100 * k * edge21 + rng.random((per, 3)) * (edge21 * 0.49)
                for k in range(3)]
    return PointsBatch(position=np.concatenate(clusters), attributes={
        "color": rng.integers(0, 256, (3 * per, 3), dtype=np.uint8)})


@pytest.fixture(scope="module")
def deep_reference(tmp_path_factory):
    from point_cloud_viewer_tpu.math.geometry import Aabb as JaxAabb

    out = str(tmp_path_factory.mktemp("deep") / "host")
    batch = _three_fat_cells()
    res = jax_build(out, 0.01, batch,
                    bounding_box=JaxAabb(np.zeros(3), np.full(3, PLANET)))
    assert res.depth_cap > 21
    return batch, out


@pytest.mark.parametrize("n_shards", [2, 8])
def test_deep_mesh_matches_jax_and_places_round_robin(tmp_path, monkeypatch,
                                                      deep_reference,
                                                      n_shards):
    """Deep + mesh (test_deep_build.py:166-215): each fat cell's sub-build
    is dispatched once, to the mesh's devices in turn, and the bytes equal
    the JAX host build's."""
    batch, ref = deep_reference
    monkeypatch.setattr(B, "_DEEP_DEVICE_MIN_N", 1_000)
    real = B._dispatch_deep_device
    used = []

    def recording(*args, device=None, **kwargs):
        used.append(device)
        return real(*args, device=device, **kwargs)

    monkeypatch.setattr(B, "_dispatch_deep_device", recording)
    mesh = make_mesh(n_shards, device="cpu")
    phases = {}
    out = str(tmp_path / "mesh")
    B.build_octree(out, 0.01, batch,
                   bounding_box=Aabb(np.zeros(3), np.full(3, PLANET)),
                   mesh=mesh, phase_times=phases)
    assert used == [mesh[i % n_shards] for i in range(3)]
    assert len(set(used)) == min(3, n_shards)
    assert phases["deep_device_subbuilds"] == 3
    assert_dirs_byte_equal(ref, out, context=f"deep mesh({n_shards})")
