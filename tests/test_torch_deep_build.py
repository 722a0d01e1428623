"""The PyTorch port's deep builds (total cap > 21: re-rooted sub-builds of
the fat level-21 cells, point_cloud_viewer_tpu_torch/octree/builder.py and
streaming.py) against the JAX package's on the CPU, byte for byte.

The clouds are the six non-mesh cases of tests/test_deep_build.py at their
sizes, the three-fat-cell recipe of its mesh case, and a fat cell with
lone points (1-point leaves, so the sub-build has extras).  One JAX
reference build serves every route of a case: the port's device route on
CPU tensors at the default threshold (every fat cell here is smaller, so
native tree_levels) and with `_DEEP_DEVICE_MIN_N` lowered (each fat cell
through the grouped derivation), the classic exchange forced, the host
route, and the streamed build with and without `use_device`.  The JAX
package's own tests hold its host, device and streamed deep builds to one
output."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from point_cloud_viewer_tpu.core.constants import MAX_POINTS_PER_NODE
from point_cloud_viewer_tpu.core.points_batch import PointsBatch
from point_cloud_viewer_tpu.math.geometry import Aabb as JaxAabb
from point_cloud_viewer_tpu.octree import builder as JB
from point_cloud_viewer_tpu.octree import streaming as JS
from point_cloud_viewer_tpu_torch.math.geometry import Aabb
from point_cloud_viewer_tpu_torch.octree import builder as PB
from point_cloud_viewer_tpu_torch.octree import streaming as PS
from point_cloud_viewer_tpu_torch.ops import tree_build as tb
from tests.conftest import assert_dirs_byte_equal
from tests.test_torch_streaming import _octant_batch

PLANET = 6.4e6  # tests/test_deep_build.py:20
EDGE21 = PLANET / (1 << 21)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _planet():
    return Aabb(np.zeros(3), np.full(3, PLANET))


def _colored(position, rng):
    n = len(position)
    return PointsBatch(position=position, attributes={
        "color": rng.integers(0, 256, (n, 3), dtype=np.uint8)})


# --- the clouds: (batch, resolution) -----------------------------------------


def _past_level_21():  # test_deep_build.py:32
    rng = np.random.default_rng(42)
    return _colored(rng.random((300_000, 3)) * 3.0, rng), 0.01


def _deterministic():  # :72
    rng = np.random.default_rng(7)
    n = 150_000
    return PointsBatch(position=rng.random((n, 3)) * 2.5, attributes={
        "intensity": rng.random(n).astype(np.float32)}), 0.01


def _very_deep_chain():  # :86, total cap 40
    rng = np.random.default_rng(3)
    return PointsBatch(position=rng.random((120_000, 3)) * 1e-3,
                       attributes={}), 1e-5


def _device_byte_identical():  # :105
    rng = np.random.default_rng(21)
    return _colored(rng.random((250_000, 3)) * 3.0, rng), 0.01


def _two_buckets():  # :129, two clusters in opposite corners
    rng = np.random.default_rng(33)
    n = 220_000
    pos = rng.random((n, 3)) * 3.0
    pos[n // 2:] += PLANET * 0.9
    return _colored(pos, rng), 0.01


def _shallow():  # :217, no level-21 cell past the threshold
    rng = np.random.default_rng(9)
    return PointsBatch(position=rng.random((50_000, 3)) * 3.0,
                       attributes={}), 0.01


def _three_fat_cells():  # :166-189, the mesh case's cloud
    rng = np.random.default_rng(17)
    per = MAX_POINTS_PER_NODE + 10_000
    clusters = [(100 * k) * EDGE21 + rng.random((per, 3)) * (EDGE21 * 0.49)
                for k in range(3)]
    return _colored(np.concatenate(clusters), rng), 0.01


def _lone_points():
    """One fat cell: a dense blob in one corner and a lone point in each of
    the other seven octants of the cell, so the sub-build has 1-point
    leaves (extras) at its level 1."""
    rng = np.random.default_rng(5)
    base = 1000 * EDGE21
    blob = base + 0.1 * EDGE21 + rng.random((MAX_POINTS_PER_NODE + 5, 3)) * 0.3
    octs = np.array([[(o >> 2) & 1, (o >> 1) & 1, o & 1] for o in range(1, 8)])
    lone = base + (octs + 0.5) * (EDGE21 / 2)
    return _colored(np.concatenate([blob, lone]), rng), 0.01


CASES = {
    "past_level_21": _past_level_21,
    "deterministic": _deterministic,
    "very_deep_chain": _very_deep_chain,
    "device_byte_identical": _device_byte_identical,
    "two_buckets": _two_buckets,
    "shallow": _shallow,
    "three_fat_cells": _three_fat_cells,
    "lone_points": _lone_points,
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """case -> (batch, resolution, JAX host build's directory, its
    BuildResult), each built once."""
    root = tmp_path_factory.mktemp("jax_deep")
    built = {}

    def get(case):
        if case not in built:
            batch, res = CASES[case]()
            out = str(root / case)
            result = JB.build_octree(
                out, res, batch, bounding_box=JaxAabb(np.zeros(3),
                                                      np.full(3, PLANET)))
            built[case] = (batch, res, out, result)
        return built[case]

    return get


def _fat_cells(batch) -> int:
    """Level-21 cells of the planet box holding more than
    MAX_POINTS_PER_NODE points: the sub-builds a deep build makes."""
    from point_cloud_viewer_tpu_torch.ops.morton import quantize_and_encode

    codes, _ = quantize_and_encode(batch.position, np.zeros(3), PLANET, 21)
    _, counts = np.unique(codes, return_counts=True)
    return int((counts > MAX_POINTS_PER_NODE).sum())


def _count_device_subbuilds(monkeypatch):
    """Records (points, device) of every fat cell derived through the
    grouped derivation (test_deep_build.py:195-211's recording wrapper)."""
    calls = []
    real = PB._dispatch_deep_device

    def recording(*args, device=None, **kwargs):
        calls.append((len(args[1]), str(device)))
        return real(*args, device=device, **kwargs)

    monkeypatch.setattr(PB, "_dispatch_deep_device", recording)
    return calls


def _force_classic_exchange(monkeypatch):
    """Every fetch takes the classic (idx, final, leaf) arrays, as on an
    extras overflow; returns the list of fetches it forced."""
    forced = []
    real = tb.fetch_grouped

    def overflowing(out):
        cap = out.extras_idx.shape[0]
        forced.append(cap)
        return real(out._replace(extras_total=torch.tensor(cap + 1)))

    monkeypatch.setattr(tb, "fetch_grouped", overflowing)
    return forced


ROUTES = ["default", "threshold_lowered", "classic_exchange", "host",
          "streamed_device", "streamed_host"]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_deep_build_matches_jax(tmp_path, reference, monkeypatch, case,
                                route):
    batch, res, ref, ref_result = reference(case)
    lowered = route in ("threshold_lowered", "classic_exchange",
                        "streamed_device")
    if lowered:
        monkeypatch.setattr(PB, "_DEEP_DEVICE_MIN_N", 1_000)
    calls = _count_device_subbuilds(monkeypatch)
    forced = (_force_classic_exchange(monkeypatch)
              if route == "classic_exchange" else None)
    out = str(tmp_path / "port")
    phases = {}
    if route.startswith("streamed"):
        result = PS.build_octree_streaming(
            out, res, batch, bounding_box=_planet(), bucket_levels=2,
            spill_directory=str(tmp_path / "spill"),
            use_device=route == "streamed_device", device="cpu",
            phase_times=phases)
    else:
        result = PB.build_octree(
            out, res, batch, bounding_box=_planet(),
            use_device=route != "host", device="cpu", phase_times=phases)
    assert_dirs_byte_equal(ref, out, context=f"{case} {route}")
    assert result.depth_cap == ref_result.depth_cap > 21
    assert result.num_points == len(batch)
    fat = _fat_cells(batch)
    assert (fat > 0) == (case != "shallow")
    assert (fat > 0) == (max(nid.level for nid, _ in result.nodes) > 21)
    # Every fat cell here is under the default threshold of 1,000,000;
    # lowered, each is derived once, on the build's device.
    expect = fat if lowered else 0
    assert len(calls) == expect, (case, route, calls)
    assert all(n > MAX_POINTS_PER_NODE and d == "cpu" for n, d in calls)
    assert phases.get("deep_device_subbuilds", 0) == expect
    if forced is not None:
        assert len(forced) == expect


@pytest.mark.parametrize("streamed", [False, True])
def test_extras_overflow_in_the_sub_build(tmp_path, reference, monkeypatch,
                                          streamed):
    """A tiny extras_cap: the lone points' 1-point leaves overflow it, so
    the sub-build fetches the classic arrays, and the bytes stay the JAX
    build's."""
    batch, res, ref, _ = reference("lone_points")
    monkeypatch.setattr(PB, "_DEEP_DEVICE_MIN_N", 1_000)
    real = tb.tree_codes_grouped_on_device
    totals = []

    def capped(*args, **kwargs):
        kwargs["extras_cap"] = 1
        out = real(*args, **kwargs)
        totals.append(int(out.extras_total))
        return out

    monkeypatch.setattr(tb, "tree_codes_grouped_on_device", capped)
    out = str(tmp_path / "port")
    if streamed:
        PS.build_octree_streaming(out, res, batch, bounding_box=_planet(),
                                  device="cpu")
    else:
        PB.build_octree(out, res, batch, bounding_box=_planet(),
                        device="cpu")
    assert len(totals) == 1 and totals[0] >= 7
    assert_dirs_byte_equal(ref, out, context="extras overflow")


def test_argsort_codes_on_device_matches_jax():
    """Ties, codes at and above 2^62 and the largest 63-bit code: the
    port's stable sort on the int64 key against JAX's padded 3-key sort."""
    from point_cloud_viewer_tpu.ops.tree_build import (
        argsort_codes_on_device as jax_argsort,
    )

    rng = np.random.default_rng(31)
    for n in (1, 7, 1000, 70_001):
        codes = rng.integers(0, 2**63, n, dtype=np.uint64)
        codes[: n // 3] = codes[0]
        codes[n // 3: n // 2] = rng.integers(2**62, 2**63, n // 2 - n // 3,
                                             dtype=np.uint64)
        codes[-(n // 5):] = np.uint64(2**63 - 1)
        got_codes, got_order = tb.argsort_codes_on_device(codes, "cpu")
        want_codes, want_order = jax_argsort(codes)
        assert got_order.dtype == want_order.dtype == np.int64
        np.testing.assert_array_equal(got_order, want_order)
        np.testing.assert_array_equal(got_codes, want_codes)


def test_discover_levels_deep_matches_jax():
    """The deep top pass's split discovery: reduced codes (fat runs cut to
    a residual) sliced, raw codes counted."""
    from point_cloud_viewer_tpu.octree.builder import (
        _discover_levels_deep as jax_discover,
    )

    rng = np.random.default_rng(12)
    raw = np.sort(rng.integers(0, 2**63, 200_000, dtype=np.uint64))
    fat_codes = raw[rng.integers(0, len(raw), 3)]
    raw = np.sort(np.concatenate(
        [raw, np.repeat(fat_codes, MAX_POINTS_PER_NODE + 1)]))
    reduced = np.sort(np.concatenate(
        [np.setdiff1d(raw, fat_codes), np.repeat(fat_codes, 5_000)]))
    for edge, res in ((PLANET, 0.001), (PLANET, 10.0)):
        got = PB._discover_levels_deep(reduced, raw, 21, edge, res)
        want = jax_discover(reduced, raw, 21, edge, res)
        assert sorted(got) == sorted(want)
        for level in want:
            for field in ("paths", "offsets", "idx"):
                np.testing.assert_array_equal(getattr(got[level], field),
                                              getattr(want[level], field))


def _legacy_marker_spill(tmp_path, monkeypatch, batch, res, bbox):
    """A JAX streaming build crashed after its spill pass, its marker then
    stripped of total_cap as a build from before total_cap wrote it."""
    spill = str(tmp_path / "spill")

    def crash(*args, **kwargs):
        raise RuntimeError("simulated crash")

    with monkeypatch.context() as m:
        m.setattr(JS, "_build_bucket_subtree", crash)
        with pytest.raises(RuntimeError, match="simulated crash"):
            JS.build_octree_streaming(
                str(tmp_path / "crashed"), res, batch, bounding_box=bbox,
                bucket_levels=1, spill_directory=spill)
    marker_path = os.path.join(spill, JS._SPILL_MARKER)
    with open(marker_path) as f:
        marker = json.load(f)
    del marker["params"]["total_cap"]
    with open(marker_path, "w") as f:
        json.dump(marker, f)
    return spill


def _poisoned():
    raise AssertionError("resume must not re-stream the input")
    yield  # pragma: no cover


@pytest.mark.parametrize("kind", ["deep", "shallow"])
def test_legacy_marker_rule_matches_jax(tmp_path, reference, monkeypatch,
                                        kind):
    """A marker without total_cap (streaming.py:253-262): a non-deep build
    resumes from it, a deep build refuses it, in both packages alike."""
    if kind == "deep":
        batch, res, _, _ = reference("two_buckets")
        bbox = JaxAabb(np.zeros(3), np.full(3, PLANET))
    else:
        batch, res = _octant_batch(105_000, 1, seed=23), 0.01
        bbox = JaxAabb.bounding_points(batch.position)
    spill = _legacy_marker_spill(tmp_path, monkeypatch, batch, res, bbox)
    shutil.copytree(spill, str(tmp_path / "spill_port"))
    outcomes = []
    for label, build, box, spill_dir in (
            ("jax", JS.build_octree_streaming, bbox, spill),
            ("port", PS.build_octree_streaming, Aabb(bbox.mins, bbox.maxs),
             str(tmp_path / "spill_port"))):
        kwargs = {"device": "cpu"} if label == "port" else {}
        try:
            build(str(tmp_path / label), res, _poisoned(), bounding_box=box,
                  bucket_levels=1, spill_directory=spill_dir, **kwargs)
            outcomes.append("resumed")
        except ValueError as e:
            assert "DIFFERENT build" in str(e)
            outcomes.append("refused")
    assert outcomes == ["refused" if kind == "deep" else "resumed"] * 2
    if kind == "shallow":
        assert_dirs_byte_equal(str(tmp_path / "jax"), str(tmp_path / "port"),
                               context="legacy marker resume")
