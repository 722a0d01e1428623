"""The PyTorch port's host build route (`use_device=False`, octree/
builder.py and streaming.py; `cli.build_octree --no-use_device`) against
the JAX package's host build on the CPU, byte for byte: in core and
streamed, below 100,000 points (the numpy split discovery and
subsampling) and above (native tree_levels), with both packages' native
libraries unloaded (every numpy fallback, deep sub-builds included), and
through the CLIs."""

import os

import numpy as np
import pytest

from point_cloud_viewer_tpu import native as jax_native
from point_cloud_viewer_tpu.core.points_batch import PointsBatch
from point_cloud_viewer_tpu.math.geometry import Aabb as JaxAabb
from point_cloud_viewer_tpu.octree import builder as JB
from point_cloud_viewer_tpu.octree import streaming as JS
from point_cloud_viewer_tpu_torch import native
from point_cloud_viewer_tpu_torch.cli.build_octree import main as cli_main
from point_cloud_viewer_tpu_torch.math.geometry import Aabb
from point_cloud_viewer_tpu_torch.octree import builder as PB
from point_cloud_viewer_tpu_torch.octree import streaming as PS
from point_cloud_viewer_tpu_torch.ops import leaf_levels_cuda as K6
from point_cloud_viewer_tpu_torch.ops import level_cuda as LC
from point_cloud_viewer_tpu_torch.ops import scan_cuda as SC
from tests.conftest import assert_dirs_byte_equal
from tests.test_torch_octree_build import _write_tiny_ply

PLANET = 6.4e6


def _cloud(n, seed):
    """Half uniform over a 20 m box, half in a Gaussian blob that splits a
    few levels down; color and intensity."""
    rng = np.random.default_rng(seed)
    position = np.concatenate([rng.random((n // 2, 3)) * 20.0,
                               6.0 + rng.normal(0.0, 0.2, (n - n // 2, 3))])
    return PointsBatch(position=position, attributes={
        "color": rng.integers(0, 256, (n, 3), dtype=np.uint8),
        "intensity": rng.random(n).astype(np.float32)})


def _deep_cloud(seed):
    """Planet box: one level-21 cell past the node threshold beside sparse
    points, so the host route runs a re-rooted sub-build."""
    rng = np.random.default_rng(seed)
    position = np.concatenate([rng.random((105_000, 3)) * 2.0 + 1e5,
                               rng.random((2_000, 3)) * 5e5])
    return PointsBatch(position=position, attributes={
        "color": rng.integers(0, 256, (len(position), 3), dtype=np.uint8)})


def _builds(tmp_path, batch, res, route, bbox=None):
    """The port's host build and the JAX host build of one batch."""
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    box = None if bbox is None else Aabb(bbox.mins, bbox.maxs)
    phases = {}
    if route == "in_core":
        result = PB.build_octree(port, res, batch, bounding_box=box,
                                 use_device=False, phase_times=phases)
        JB.build_octree(ref, res, batch, bounding_box=bbox)
    else:
        result = PS.build_octree_streaming(
            port, res, batch, bounding_box=box, bucket_levels=1,
            spill_directory=str(tmp_path / "spill"), use_device=False,
            phase_times=phases)
        JS.build_octree_streaming(ref, res, batch, bounding_box=bbox,
                                  bucket_levels=1)
    assert_dirs_byte_equal(ref, port, context=f"host {route}")
    assert result.num_points == len(batch)
    return result, phases


@pytest.mark.parametrize("route", ["in_core", "streamed"])
@pytest.mark.parametrize("n", [60_000, 250_000])
def test_host_build_matches_jax(tmp_path, route, n):
    """Below 100,000 points the in-core build takes the numpy pair, at or
    above native tree_levels; the streamed build's split buckets (here only
    at 250,000 points) take tree_levels.  No kernel wrapper counts a launch, and the device is
    never asked for (the default device is cuda, absent here)."""
    wrappers = (SC.scan_1d, LC.seg_start_pass, LC.leaf_update_pass,
                LC.promote_pass, LC.promote_stage, K6.leaf_stage)
    before = [w.launches for w in wrappers]
    result, phases = _builds(tmp_path, _cloud(n, seed=n), 0.001, route)
    assert [w.launches for w in wrappers] == before
    assert len(result.nodes) > 8
    if route == "in_core":
        assert [k for k in phases if "/" not in k] == [
            "quantize+morton", "sort", "discover+subsample", "encode+write"]
        assert {k for k in phases if "/" in k} == {
            "encode+write/encode", "encode+write/wait", "encode+write/write"}
    else:
        # Only a bucket past the node threshold is derived (tree_levels).
        assert ("bucket_derive" in phases) == (n > 100_000)
        assert "buckets_derived" not in phases


@pytest.fixture
def no_native(monkeypatch):
    """Both packages' host libraries switched off by PCV_DISABLE_NATIVE:
    every native entry point returns None."""
    monkeypatch.setenv("PCV_DISABLE_NATIVE", "1")
    assert not native.available() and not jax_native.available()


@pytest.mark.parametrize("route", ["in_core", "streamed"])
@pytest.mark.parametrize("deep", [False, True])
def test_host_build_without_native_library_matches_jax(tmp_path, no_native,
                                                       route, deep):
    if deep:
        batch = _deep_cloud(seed=4)
        bbox = JaxAabb(np.zeros(3), np.full(3, PLANET))
        result, _ = _builds(tmp_path, batch, 0.01, route, bbox=bbox)
        assert max(node.level for node, _ in result.nodes) > 21
    else:
        _builds(tmp_path, _cloud(150_000, seed=6), 0.001, route)


@pytest.mark.parametrize("streaming", [False, True])
def test_cli_host_route_matches_jax_cli(tmp_path, capsys, streaming):
    """cli.build_octree --no-use_device (in core and --streaming) against
    the JAX CLI's host build; --device is not consulted."""
    from point_cloud_viewer_tpu.cli.build_octree import main as jax_cli

    ply = str(tmp_path / "tiny.ply")
    _write_tiny_ply(ply, 120_000, seed=10)
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    extra = ["--streaming", "--bucket_levels", "1"] if streaming else []
    phases = {}
    assert cli_main([ply, "--output_directory", port, "--no-use_device",
                     "--device", "cuda", *extra], phase_times=phases) == 0
    assert jax_cli([ply, "--output_directory", ref, *extra]) == 0
    assert_dirs_byte_equal(ref, port, context="port host CLI vs JAX CLI")
    assert ("top" if streaming else "sort") in phases
    assert "Built octree with 120000 points" in capsys.readouterr().out
    assert os.path.exists(os.path.join(port, "meta.pb"))
