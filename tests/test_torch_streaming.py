"""The PyTorch port's out-of-core build (point_cloud_viewer_tpu_torch/octree/
streaming.py and cli/build_octree.py --streaming) against the JAX
package's on the CPU: the same numpy-seeded clouds through both, the
octree directories compared byte for byte.  The port runs its device
route on CPU tensors (the kernels' plain versions); the JAX side runs its
streaming build, which tests/test_streaming_build.py holds byte-equal to
its in-core and device builds.  Checkpoints cross between the packages."""

import json
import os

import numpy as np
import pytest

from point_cloud_viewer_tpu.core.points_batch import PointsBatch
from point_cloud_viewer_tpu.math.geometry import Aabb
from point_cloud_viewer_tpu.octree import streaming as JS
from point_cloud_viewer_tpu.octree.octree import Octree
from point_cloud_viewer_tpu_torch.cli.build_octree import main as cli_main
from point_cloud_viewer_tpu_torch.octree import streaming as PS
from point_cloud_viewer_tpu_torch.ops import level_cuda as LC
from point_cloud_viewer_tpu_torch.ops import scan_cuda as SC
from tests.conftest import assert_dirs_byte_equal
from tests.test_streaming_build import _one_point_leaf_batch
from tests.test_torch_octree_build import _write_tiny_ply


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small per-level tensor ops: one intra-op thread is faster here, and
    far faster when test workers share the cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bbox(batch):
    return Aabb.bounding_points(batch.position)


def _colored(position, seed, intensity=False):
    rng = np.random.default_rng(seed)
    n = len(position)
    attrs = {"color": rng.integers(0, 256, (n, 3), dtype=np.uint8)}
    if intensity:
        attrs["intensity"] = rng.random(n).astype(np.float32)
    return PointsBatch(position=position, attributes=attrs)


def _compare(tmp_path, batch, resolution, bucket_levels=2, batches=None,
             phase_times=None):
    """Port streaming (device route on the CPU) vs JAX streaming."""
    ref, port = str(tmp_path / "jax"), str(tmp_path / "port")
    data = batches if batches is not None else batch
    bbox = None if batches is None else _bbox(batch)
    JS.build_octree_streaming(ref, resolution, data, bounding_box=bbox,
                              bucket_levels=bucket_levels)
    result = PS.build_octree_streaming(
        port, resolution, data, bounding_box=bbox,
        bucket_levels=bucket_levels, spill_directory=str(tmp_path / "spill"),
        device="cpu", phase_times=phase_times,
    )
    assert_dirs_byte_equal(ref, port, context="port vs JAX streaming")
    assert result.num_points == len(batch)
    return port


def _octant_batch(n_per, octants, seed):
    """n_per points in each of the first `octants` level-1 cells of a 40 m
    cube, so each of those buckets splits into a subtree of its own."""
    rng = np.random.default_rng(seed)
    parts = []
    for o in range(octants):
        corner = 20.0 * np.array([(o >> 2) & 1, (o >> 1) & 1, o & 1])
        parts.append(corner + rng.random((n_per, 3)) * 20.0)
    parts.append(np.array([[0.0, 0.0, 0.0], [40.0, 40.0, 40.0]]))
    return _colored(np.concatenate(parts), seed)


def test_uniform_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    batch = _colored(rng.random((200_000, 3)) * 50.0, 0, intensity=True)
    _compare(tmp_path, batch, 0.001)


def test_clustered_matches_jax(tmp_path):
    """Shallow leaves in some octants, deep splits in others."""
    rng = np.random.default_rng(1)
    position = np.concatenate([
        rng.normal([5, 5, 5], 0.05, (130_000, 3)),
        rng.random((3_000, 3)) * 100.0,
        rng.normal([80, 80, 10], 0.5, (40_000, 3)),
    ])
    phases = {}
    _compare(tmp_path, _colored(position, 1), 0.001, phase_times=phases)
    assert {"spill", "bucket_load", "bucket_quantize",
            "bucket_device_dispatch", "bucket_device_derive",
            "bucket_device_wait", "bucket_group", "bucket_encode_write",
            "top", "bucket_upload_bytes", "bucket_fetch_bytes"} <= set(phases)


def test_batched_input_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    n = 120_000
    batch = _colored(rng.random((n, 3)) * 10.0, 2)
    batches = [batch.slice(s, min(n, s + 25_000)) for s in range(0, n, 25_000)]
    _compare(tmp_path, batch, 0.01, batches=batches)


def test_empty_batch_in_stream_matches_jax(tmp_path):
    rng = np.random.default_rng(11)
    n = 20_000
    batch = _colored(rng.random((n, 3)) * 10.0, 11)
    empty = PointsBatch(position=np.zeros((0, 3)),
                        attributes={"color": np.zeros((0, 3), dtype=np.uint8)})
    batches = [empty, batch.slice(0, n // 2), empty, batch.slice(n // 2, n),
               empty]
    _compare(tmp_path, batch, 0.01, batches=batches)


@pytest.mark.parametrize("n", [1, 2])
def test_small_and_single_match_jax(tmp_path, n):
    batch = PointsBatch(
        position=np.array([[1.0, 2.0, 3.0], [1.1, 2.1, 3.1]])[:n],
        attributes={"color": np.array([[1, 2, 3], [4, 5, 6]],
                                      dtype=np.uint8)[:n]},
    )
    _compare(tmp_path, batch, 0.01)


def test_empty_cloud_matches_jax(tmp_path):
    batch = PointsBatch(position=np.zeros((0, 3)), attributes={})
    port = _compare(tmp_path, batch, 0.01)
    assert os.listdir(port) == ["meta.pb"]


@pytest.mark.parametrize("bucket_levels", [1, 2, 3])
def test_bucket_levels_match_jax(tmp_path, bucket_levels):
    batch = _octant_batch(60_000, 3, seed=3)
    batch = PointsBatch.concatenate([
        batch, _colored(np.full((110_000, 3), 7.0)
                        + np.random.default_rng(4).random((110_000, 3)), 4)])
    _compare(tmp_path, batch, 0.001, bucket_levels=bucket_levels)


def test_pipelined_buckets_match_jax(tmp_path, monkeypatch):
    """Three buckets past the node threshold: each is dispatched while the
    one before it is finished (FIFO), as streaming.py:374-455."""
    events = []
    dispatch, finish = PS._dispatch_device_bucket, PS._finish_device_bucket

    def spy_dispatch(*args, **kwargs):
        events.append("dispatch")
        return dispatch(*args, **kwargs)

    def spy_finish(*args, **kwargs):
        events.append("finish")
        return finish(*args, **kwargs)

    monkeypatch.setattr(PS, "_dispatch_device_bucket", spy_dispatch)
    monkeypatch.setattr(PS, "_finish_device_bucket", spy_finish)
    port = _compare(tmp_path, _octant_batch(105_000, 3, seed=5), 0.001,
                    bucket_levels=1)
    assert events == ["dispatch", "dispatch", "finish", "dispatch", "finish",
                      "finish"]
    assert len(os.listdir(port)) > 12


def test_one_point_leaves_fetch_the_grouped_exchange(tmp_path):
    """Empty nodes of promoted-away 1-point leaves, recorded through the
    extras, with the grouped exchange (< 5.5 B/pt) as
    test_streaming_build.py:472-494."""
    batch = _one_point_leaf_batch()
    phases = {}
    port = _compare(tmp_path, batch, 0.01, bucket_levels=1,
                    phase_times=phases)
    assert (Octree.from_directory(port).num_points == 0).sum() >= 1
    assert 0 < phases["bucket_fetch_bytes"] < 5.5 * len(batch)
    assert phases["bucket_upload_bytes"] == 8 * 100_007  # the split bucket


def test_extras_overflow_falls_back(tmp_path, monkeypatch):
    """extras_cap forced to 1 (as test_streaming_build.py:497-520): the
    finish fetches the classic (idx, final, leaf) arrays, 6 B/pt."""
    from point_cloud_viewer_tpu_torch.ops import tree_build

    orig = tree_build.tree_codes_grouped_on_device

    def capped(*args, **kwargs):
        kwargs["extras_cap"] = 1
        return orig(*args, **kwargs)

    monkeypatch.setattr(tree_build, "tree_codes_grouped_on_device", capped)
    phases = {}
    _compare(tmp_path, _one_point_leaf_batch(), 0.01, bucket_levels=1,
             phase_times=phases)
    n_split = phases["bucket_upload_bytes"] / 8
    assert phases["bucket_fetch_bytes"] == 4 + 6 * n_split


def _crash_on_call(monkeypatch, module, name, k):
    real = getattr(module, name)
    calls = {"n": 0}

    def exploding(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == k:
            raise RuntimeError("simulated crash")
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, exploding)


def _poisoned():
    raise AssertionError("resume must not re-stream the input")
    yield  # pragma: no cover


def _resume_in_port(tmp_path, batch, spill):
    """The same call again, into the crashed build's output directory,
    which holds the finished buckets' node files."""
    out = str(tmp_path / "crashy")
    result = PS.build_octree_streaming(
        out, 0.01, _poisoned(), bounding_box=_bbox(batch), bucket_levels=1,
        spill_directory=spill, device="cpu",
    )
    assert result.num_points == len(batch)
    return out


def test_resume_after_crash_matches_jax(tmp_path, monkeypatch):
    """A crash while finishing the second of three split buckets, then the
    same call: the finished bucket comes from its checkpoint record."""
    batch = _octant_batch(105_000, 3, seed=7)
    ref = str(tmp_path / "jax")
    JS.build_octree_streaming(ref, 0.01, batch, bucket_levels=1)
    spill = str(tmp_path / "spill")
    with monkeypatch.context() as m:
        _crash_on_call(m, PS, "_finish_device_bucket", 2)
        with pytest.raises(RuntimeError, match="simulated crash"):
            PS.build_octree_streaming(
                str(tmp_path / "crashy"), 0.01, batch, bucket_levels=1,
                spill_directory=spill, device="cpu",
            )
    assert os.path.exists(os.path.join(spill, PS._SPILL_MARKER))
    assert [f for f in os.listdir(spill) if f.startswith("_done_b")]
    out = _resume_in_port(tmp_path, batch, spill)
    assert_dirs_byte_equal(ref, out, context="port resume vs JAX")
    assert not os.path.exists(spill) or not os.listdir(spill)


def test_resume_from_jax_checkpoint(tmp_path, monkeypatch):
    """A spill directory left by a crashed JAX build resumes in the port."""
    batch = _octant_batch(105_000, 3, seed=8)
    ref = str(tmp_path / "jax")
    JS.build_octree_streaming(ref, 0.01, batch, bucket_levels=1)
    spill = str(tmp_path / "spill")
    with monkeypatch.context() as m:
        _crash_on_call(m, JS, "_build_bucket_subtree", 2)
        with pytest.raises(RuntimeError, match="simulated crash"):
            JS.build_octree_streaming(
                str(tmp_path / "crashy"), 0.01, batch, bucket_levels=1,
                spill_directory=spill,
            )
    done = [f for f in os.listdir(spill) if f.startswith("_done_b")]
    assert len(done) == 2  # one bucket's .json + .npz
    out = _resume_in_port(tmp_path, batch, spill)
    assert_dirs_byte_equal(ref, out, context="port resume of a JAX spill")


def test_restart_after_spill_crash_and_marker_checks(tmp_path):
    """Partial spill files with no marker are cleared; a corrupt marker is
    a clean slate; a valid marker of other params raises; a marker from
    before total_cap resumes (test_streaming_build.py:226-290, 523-573)."""
    rng = np.random.default_rng(13)
    batch = _colored(rng.random((30_000, 3)) * 32.0, 13)
    ref = str(tmp_path / "jax")
    JS.build_octree_streaming(ref, 0.01, batch, bucket_levels=1)
    spill = str(tmp_path / "spill")
    os.makedirs(spill)
    with open(os.path.join(spill, "b0003.position"), "wb") as f:
        f.write(b"\x00" * 1234)
    with open(os.path.join(spill, PS._SPILL_MARKER), "w") as f:
        f.write('{"params": {"resol')
    out = str(tmp_path / "port")
    PS.build_octree_streaming(out, 0.01, batch, bucket_levels=1,
                              spill_directory=spill, device="cpu")
    assert_dirs_byte_equal(ref, out, context="restart after spill crash")
    os.makedirs(spill, exist_ok=True)
    with open(os.path.join(spill, PS._SPILL_MARKER), "w") as f:
        json.dump({"params": {"resolution": 0.5}}, f)
    with pytest.raises(ValueError, match="DIFFERENT build"):
        PS.build_octree_streaming(str(tmp_path / "other"), 0.01, batch,
                                  bucket_levels=1, spill_directory=spill,
                                  device="cpu")


def test_legacy_marker_resumes(tmp_path, monkeypatch):
    batch = _octant_batch(105_000, 1, seed=9)
    bbox = _bbox(batch)
    spill = str(tmp_path / "spill")
    with monkeypatch.context() as m:
        _crash_on_call(m, PS, "_finish_device_bucket", 1)
        with pytest.raises(RuntimeError):
            PS.build_octree_streaming(str(tmp_path / "a"), 0.01, batch,
                                      bounding_box=bbox, bucket_levels=1,
                                      spill_directory=spill, device="cpu")
    marker_path = os.path.join(spill, PS._SPILL_MARKER)
    with open(marker_path) as f:
        marker = json.load(f)
    assert marker["params"].pop("total_cap") == marker["params"]["depth_cap"]
    with open(marker_path, "w") as f:
        json.dump(marker, f)
    out = str(tmp_path / "b")
    PS.build_octree_streaming(out, 0.01, _poisoned(), bounding_box=bbox,
                              bucket_levels=1, spill_directory=spill,
                              device="cpu")
    ref = str(tmp_path / "jax")
    JS.build_octree_streaming(ref, 0.01, batch, bounding_box=bbox,
                              bucket_levels=1)
    assert_dirs_byte_equal(ref, out, context="legacy marker resume")


def test_one_shot_iterator_and_unknown_attribute_raise(tmp_path):
    rng = np.random.default_rng(12)
    batch = _colored(rng.random((1000, 3)), 12)
    with pytest.raises(ValueError, match="one-shot iterator"):
        PS.build_octree_streaming(str(tmp_path / "o"), 0.01,
                                  (b for b in [batch]), device="cpu")
    for bbox in (None, _bbox(batch)):
        with pytest.raises(ValueError,
                           match="requested attributes not in input"):
            PS.build_octree_streaming(str(tmp_path / "o2"), 0.01, [batch],
                                      bounding_box=bbox, attributes=["colr"],
                                      device="cpu")


def test_unported_routes_raise(tmp_path):
    batch = PointsBatch(position=np.array([[0.0, 0.0, 0.0], [1e7, 1e7, 1e7]]),
                        attributes={})
    with pytest.raises(NotImplementedError, match="deep build"):
        PS.build_octree_streaming(str(tmp_path / "o"), 0.001, batch,
                                  device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        PS.build_octree_streaming(str(tmp_path / "o"), 0.001, batch,
                                  use_device=False, device="cpu")


def test_cpu_route_launches_no_kernel(tmp_path):
    wrappers = (SC.scan_1d, LC.seg_start_pass, LC.leaf_update_pass,
                LC.promote_pass, LC.promote_stage)
    before = [w.launches for w in wrappers]
    PS.build_octree_streaming(str(tmp_path / "o"), 0.001,
                              _octant_batch(101_000, 1, seed=10),
                              bucket_levels=1, device="cpu")
    assert [w.launches for w in wrappers] == before


def test_discover_subtree_levels_matches_jax():
    """The host split discovery, copied for the bucket path, against the
    JAX function, and the subsampling over its output."""
    from point_cloud_viewer_tpu.octree.builder import (
        _subsample_bottom_up as jax_subsample,
    )
    from point_cloud_viewer_tpu_torch.octree.builder import (
        _subsample_bottom_up,
    )

    rng = np.random.default_rng(14)
    cells = rng.integers(0, 2**9, (60_000, 3)).astype(np.uint32)
    cells[:45_000] = cells[:45_000] % 16  # dense corner: deep splits
    from point_cloud_viewer_tpu_torch.ops.morton import morton_encode

    codes = np.sort(morton_encode(cells))
    bucket = int(codes[0] >> np.uint64(3 * 9))
    codes = codes[(codes >> np.uint64(3 * 9)) == bucket]
    for root_edge, resolution in ((512.0, 1.0), (512.0, 8.0)):
        args = (codes, len(codes), 9, root_edge, resolution, bucket, 0)
        got = PS._discover_subtree_levels(*args)
        want = JS._discover_subtree_levels(*args)
        assert sorted(got) == sorted(want)
        for level in want:
            for field in ("paths", "offsets", "idx"):
                np.testing.assert_array_equal(getattr(got[level], field),
                                              getattr(want[level], field))
        for stop in (0, 1):
            a, b = _subsample_bottom_up(got, stop), jax_subsample(want, stop)
            assert sorted(a) == sorted(b)
            for level in b:
                np.testing.assert_array_equal(a[level].idx, b[level].idx)
                np.testing.assert_array_equal(a[level].offsets,
                                              b[level].offsets)


def test_cli_streaming_matches_jax_cli(tmp_path, capsys):
    from point_cloud_viewer_tpu.cli.build_octree import main as jax_cli

    ply = str(tmp_path / "tiny.ply")
    _write_tiny_ply(ply, 3_000, seed=9)
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    spill = str(tmp_path / "spill")
    phases = {}
    assert cli_main([ply, "--output_directory", port, "--use_device",
                     "--device", "cpu", "--streaming", "--bucket_levels", "1",
                     "--spill_directory", spill], phase_times=phases) == 0
    assert jax_cli([ply, "--output_directory", ref, "--streaming",
                    "--bucket_levels", "1"]) == 0
    assert_dirs_byte_equal(ref, port, context="port streaming CLI vs JAX")
    assert "spill" in phases and "top" in phases
    assert "Built octree with 3000 points" in capsys.readouterr().out
    assert not os.path.exists(spill) or not os.listdir(spill)


@pytest.mark.parametrize("flags,use_device,message", [
    (["--spill_directory", "s"], True, "requires --streaming"),
    (["--streaming", "--mesh", "2"], True, "not supported with --streaming"),
    (["--streaming"], False, "not yet ported"),
])
def test_cli_streaming_argument_errors(tmp_path, capsys, flags, use_device,
                                       message):
    ply = str(tmp_path / "tiny.ply")
    _write_tiny_ply(ply, 10, seed=1)
    args = [ply, "--output_directory", str(tmp_path / "o"), *flags]
    args.append("--use_device" if use_device else "--no-use_device")
    with pytest.raises(SystemExit) as exc:
        cli_main(args)
    assert exc.value.code != 0
    assert message in capsys.readouterr().err
