"""The port's x-ray path (point_cloud_viewer_tpu_torch.xray) against the
JAX package on the CPU, from the same seeded numpy inputs.

Tolerances: exact everywhere (dtypes, shapes and bits; PNG files byte for
byte) except where a full-f64 height sum meets a summation order other
than the host's: the port's CPU route against the JAX package's device
route (XLA's scatter order) on heights not on a fixed step, where a pixel
may differ by 1 per channel; the test counts the differing pixels and
prints them.  The port's CPU route adds in index order, as np.bincount
does, so it equals the host route on every input.
"""

import os

import numpy as np
import pytest
import torch

from point_cloud_viewer_tpu.core.points_batch import PointsBatch as JBatch
from point_cloud_viewer_tpu.math.geometry import Aabb as JAabb
from point_cloud_viewer_tpu.xray import device_splat as JDS
from point_cloud_viewer_tpu.xray import generation as JG
from point_cloud_viewer_tpu_torch import testing as T
from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
from point_cloud_viewer_tpu_torch.math.geometry import Aabb
from point_cloud_viewer_tpu_torch.xray import device_splat as DS
from point_cloud_viewer_tpu_torch.xray import generation as G
from tests.conftest import assert_dirs_byte_equal


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensor ops: one intra-op thread beside the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(a, b, what=""):
    assert T.same_bits(a, b), (what, np.asarray(a).dtype, np.asarray(b).dtype,
                               np.asarray(a).shape, np.asarray(b).shape)


# --- the four reductions ----------------------------------------------------


def _jax_outputs(i, size):
    """device_splat of the JAX package on xray_splat_inputs."""
    return {
        "occupancy": (JDS.xray_occupancy_device(i["keys"], size),),
        "color_sums": JDS.color_sums_device(i["pix"], i["color"], size),
        "height_moments": JDS.moment_sums_device(i["pix"], i["height"], size),
        "intensity_moments": JDS.moment_sums_device(i["pix"], i["intensity"],
                                                    size),
        "binned": JDS.binned_run_reduce_device(i["pix"], i["bins"],
                                               i["vals"]),
    }


def _host_outputs(i, size):
    """The same reductions by the host's np.unique / np.bincount."""
    npx = size * size
    occ = np.zeros(npx, np.int32)
    if len(i["keys"]):
        p, c = np.unique(np.unique(i["keys"]) // 2048, return_counts=True)
        occ[p] = c
    counts = np.bincount(i["pix"], minlength=npx).astype(np.int32)
    sums = np.stack([np.bincount(i["pix"], weights=i["color"][:, c],
                                 minlength=npx) for c in range(3)], 1)

    def bincount(idx, weights, minlength):
        # np.bincount of an empty input gives int64 even with weights.
        return np.bincount(idx, weights=weights,
                           minlength=minlength).astype(np.float64)

    def moments(v):
        return (counts, bincount(i["pix"], v, npx),
                bincount(i["pix"], v * v, npx))

    key = np.stack([i["pix"], i["bins"]], axis=1).reshape(-1, 2)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    run_sums = np.stack([bincount(inv, i["vals"][:, c], len(uniq))
                         for c in range(i["vals"].shape[1])], 1)
    return {
        "occupancy": (occ,),
        "color_sums": (sums.astype(np.uint32), counts),
        "height_moments": moments(i["height"]),
        "intensity_moments": moments(i["intensity"]),
        "binned": (uniq[:, 0].astype(np.int64),
                   np.bincount(inv, minlength=len(uniq)).astype(np.int64),
                   run_sums.reshape(len(uniq), i["vals"].shape[1])),
    }


@pytest.mark.parametrize("n,size", [(0, 64), (1, 8), (50_000, 64),
                                    (20_000, 1448)])
def test_reductions_match_jax_under_the_condition(n, size):
    """Heights and intensities on a 1/64 step: every output of the port's
    CPU route equals the JAX package's and the host's bit for bit, the
    empty input and image_size 1448 (the packed keyspace's largest)
    included."""
    inputs = T.xray_splat_inputs(n, size, seed=n + size)
    got = T.xray_splat_outputs(inputs, size, "cpu")
    assert T.xray_splat_differences(got, _jax_outputs(inputs, size)) == []
    assert T.xray_splat_differences(got, _host_outputs(inputs, size)) == []


def test_reductions_on_full_f64_match_the_host_order():
    """Heights and intensities off any step: the port's CPU route still
    equals the host's np.bincount bit for bit (both add in index order);
    the integer outputs equal the JAX package's."""
    inputs = T.xray_splat_inputs(50_000, 64, seed=3, step=None)
    got = T.xray_splat_outputs(inputs, 64, "cpu")
    assert T.xray_splat_differences(got, _host_outputs(inputs, 64)) == []
    jax_out = _jax_outputs(inputs, 64)
    for name, k in (("occupancy", 0), ("color_sums", 0), ("color_sums", 1),
                    ("height_moments", 0), ("binned", 0), ("binned", 1)):
        _same(got[name][k], jax_out[name][k], (name, k))


def test_occupancy_refuses_past_1448_as_jax():
    keys = np.array([5, 9], dtype=np.int64)
    with pytest.raises(ValueError) as e_port:
        DS.xray_occupancy_device(keys, 1449, "cpu")
    with pytest.raises(ValueError) as e_jax:
        JDS.xray_occupancy_device(keys, 1449)
    assert str(e_port.value) == str(e_jax.value)
    assert DS.xray_occupancy_device(keys, 1448, "cpu").shape == (1448 ** 2,)


# --- the strategies ---------------------------------------------------------

_FAMILIES = [
    ("xray", {}),
    ("colored", {}),
    ("colored_with_intensity", {"min_intensity": 0.1, "max_intensity": 100.0}),
    ("colored_with_height_stddev", {"max_stddev": 2.0}),
    ("colored", {"binning": ("ts", 10.0)}),
    ("colored_with_intensity", {"min_intensity": 0.1, "max_intensity": 100.0,
                                "binning": ("ts", 10.0)}),
]


def _family_id(family):
    kind, kwargs = family
    return kind + ("_binned" if "binning" in kwargs else "")


def _batches(seed, n, step=1.0 / 64.0):
    """tests/test_xray_strategies.py:232-250's two batches (z and the
    intensities on a 1/64 step unless step is None), as (JAX, port)
    PointsBatch pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        p = rng.random((n // 2, 3)) * np.array([10.0, 10.0, 5.0])
        if step is not None:
            p[:, 2] = np.round(p[:, 2] / step) * step
        attrs = {
            "color": rng.integers(0, 256, (n // 2, 3), dtype=np.uint8),
            "intensity": (rng.integers(64, 6400, n // 2) / 64.0
                          ).astype(np.float32),
            "ts": rng.random(n // 2) * 70.0 - 10.0,
        }
        out.append((JBatch(position=p, attributes=dict(attrs)),
                    PointsBatch(position=p.copy(), attributes=dict(attrs))))
    return out


def _render(make, kind, kwargs, batches, which, size, bbox):
    s = make(kind, **kwargs)
    for pair in batches:
        s.process(pair[which], bbox, size)
    return s.render(size)


@pytest.mark.parametrize("family", _FAMILIES, ids=_family_id)
def test_strategies_match_jax_exactly(family):
    """tests/test_xray_strategies.py::test_device_splat_matches_host_exactly
    for the port: its CPU route and its numpy route (device=None) render
    the same u8 image as the JAX package's device and host routes, bit for
    bit, under the exactness condition."""
    kind, kwargs = family
    size = 64
    batches = _batches(99, 120_000)
    jbox = JAabb(np.zeros(3), np.array([10.0, 10.0, 5.0]))
    box = Aabb(np.zeros(3), np.array([10.0, 10.0, 5.0]))
    want = _render(JG.make_strategy, kind, kwargs, batches, 0, size, jbox)
    jax_dev = _render(JG.make_strategy, kind, dict(kwargs, device=True),
                      batches, 0, size, jbox)
    _same(jax_dev, want, "JAX device route")
    for device in ("cpu", None):
        got = _render(G.make_strategy, kind, dict(kwargs, device=device),
                      batches, 1, size, box)
        _same(got, want, device)


def test_full_f64_heights_within_one_lsb_of_jax_device():
    """Heights off any step: the port's CPU route equals the JAX host route
    byte for byte; against the JAX device route (another summation order)
    each pixel differs by at most 1 per channel."""
    kind, kwargs = "colored_with_height_stddev", {"max_stddev": 2.0}
    size = 64
    batches = _batches(7, 120_000, step=None)
    jbox = JAabb(np.zeros(3), np.array([10.0, 10.0, 5.0]))
    box = Aabb(np.zeros(3), np.array([10.0, 10.0, 5.0]))
    got = _render(G.make_strategy, kind, dict(kwargs, device="cpu"), batches,
                  1, size, box)
    _same(got, _render(JG.make_strategy, kind, kwargs, batches, 0, size, jbox))
    jax_dev = _render(JG.make_strategy, kind, dict(kwargs, device=True),
                      batches, 0, size, jbox)
    diff = np.abs(got.astype(int) - jax_dev.astype(int))
    print(f"full-f64 heights: {int((diff.max(axis=2) > 0).sum())} of "
          f"{size * size} pixels differ from the JAX device route, by at "
          f"most {int(diff.max())}")
    assert diff.max() <= 1


def test_binned_wide_range_intensities_match_jax():
    """tests/test_xray_strategies.py::
    test_binned_device_wide_range_intensities: f32 intensities over ~26
    binary orders, binned; the port's CPU route equals the JAX package's
    host and device routes."""
    rng = np.random.default_rng(123)
    n, size = 60_000, 32
    intensity = np.exp(rng.uniform(np.log(1e-3), np.log(5e4), n)).astype(
        np.float32)
    p = rng.random((n, 3)) * np.array([10.0, 10.0, 5.0])
    attrs = {"intensity": intensity, "ts": rng.random(n) * 50.0}
    batches = [(JBatch(position=p, attributes=dict(attrs)),
                PointsBatch(position=p.copy(), attributes=dict(attrs)))]
    kwargs = {"min_intensity": 1e-3, "max_intensity": 5e4,
              "binning": ("ts", 10.0)}
    kind = "colored_with_intensity"
    jbox = JAabb(np.zeros(3), np.array([10.0, 10.0, 5.0]))
    box = Aabb(np.zeros(3), np.array([10.0, 10.0, 5.0]))
    want = _render(JG.make_strategy, kind, kwargs, batches, 0, size, jbox)
    _same(_render(JG.make_strategy, kind, dict(kwargs, device=True), batches,
                  0, size, jbox), want)
    for device in ("cpu", None):
        _same(_render(G.make_strategy, kind, dict(kwargs, device=device),
                      batches, 1, size, box), want, device)


# The unit cases of tests/test_xray_strategies.py, each a list of
# (points, attributes) batches over its 8 m box at 8 px, with the strategy.
_PTS_32 = [[0.5, 7.9, (i + 0.5) * (8.0 / 1024.0)] for i in range(32)]
_CASES = {
    "density": ("xray", {}, [(_PTS_32 + [[1.5, 7.9, 0.1]], {})]),
    "color_mean": ("colored", {}, [([[0.5, 7.9, 1.0], [0.5, 7.9, 2.0]], {
        "color": np.array([[100, 0, 0], [200, 0, 0]], np.uint8)})]),
    "color_binned_mean": ("colored", {"binning": ("ts", 10.0)}, [(
        [[0.5, 7.9, 1.0]] * 3 + [[0.5, 7.9, 2.0]],
        {"color": np.array([[100, 0, 0]] * 3 + [[200, 0, 0]], np.uint8),
         "ts": np.array([0.0, 1.0, 2.0, 10.0])})]),
    "intensity_brighten": ("colored_with_intensity",
                           {"min_intensity": 1.0, "max_intensity": 101.0},
                           [([[0.5, 7.9, 1.0]],
                             {"intensity": np.array([51.0], np.float32)})]),
    "intensity_negative_dropped": (
        "colored_with_intensity", {"min_intensity": 1.0,
                                   "max_intensity": 100.0},
        [([[0.5, 7.9, 1.0], [1.5, 7.9, 1.0]],
          {"intensity": np.array([-5.0, 50.0], np.float32)}),
         ([[0.5, 7.9, 1.0]], {"intensity": np.array([-5.0], np.float32)})]),
    "height_jet": ("colored_with_height_stddev", {"max_stddev": 2.0},
                   [([[0.5, 7.9, 1.0], [0.5, 7.9, 3.0]], {})]),
    "height_purplish": ("colored_with_height_stddev",
                        {"max_stddev": 2.0, "colormap": "purplish"},
                        [([[0.5, 7.9, 1.0], [0.5, 7.9, 3.0]], {})]),
    "contribution_free": ("colored", {}, [
        ([[0.5, 0.0, 1.0]], {"color": np.array([[10, 20, 30]], np.uint8)}),
        (np.zeros((0, 3)), {"color": np.zeros((0, 3), np.uint8)}),
        ([[0.5, 7.9, 1.0]], {"color": np.array([[10, 20, 30]], np.uint8)})]),
}


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("device", ["cpu", None])
def test_unit_cases_match_jax(case, device):
    """The formula cases of tests/test_xray_strategies.py render the same
    8 x 8 image in the port (CPU route and numpy route) as in the JAX
    package's host route."""
    kind, kwargs, batches = _CASES[case]
    pairs = [(JBatch(position=np.asarray(p, np.float64), attributes=a),
              PointsBatch(position=np.asarray(p, np.float64), attributes=a))
             for p, a in batches]
    want = _render(JG.make_strategy, kind, kwargs, pairs, 0, 8,
                   JAabb([0, 0, 0], [8.0, 8.0, 8.0]))
    got = _render(G.make_strategy, kind, dict(kwargs, device=device), pairs,
                  1, 8, Aabb([0, 0, 0], [8.0, 8.0, 8.0]))
    _same(got, want)
    assert want[:, :, 3].any()


def test_discretize_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.random((20_000, 3)) * 12.0 - 2.0
    pts[:4] = [[0.0, 8.0, 0.0], [8.0, 0.0, 8.0], [np.nan, 1.0, 1.0],
               [1.0, 1.0, np.inf]]
    for got, want in zip(G.discretize(pts, Aabb([0, 0, 0], [8.0, 8.0, 8.0]),
                                      64),
                         JG.discretize(pts, JAabb([0, 0, 0], [8.0, 8.0, 8.0]),
                                       64)):
        _same(got, want)


def test_strategies_default_to_the_card(monkeypatch):
    """Without a device argument a strategy (and make_strategy) asks for
    CUDA, and raises where torch sees no card; None is the numpy route."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: G.XRayStrategy(), lambda: G.PointColorStrategy(),
                 lambda: G.IntensityStrategy(1.0, 2.0),
                 lambda: G.HeightStddevStrategy(1.0),
                 lambda: G.make_strategy("colored")):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    assert G.make_strategy("xray", device=None).device is None
    assert G.make_strategy("xray", device="cpu").device == torch.device("cpu")


# --- the pyramid build and its CLI over a JAX-built octree ------------------


@pytest.fixture(scope="module")
def cloud_dir(tmp_path_factory):
    """tests/test_xray.py's cloud (60,000 points over 4 x 4 x 1 m, color and
    intensity), built by the JAX package."""
    from point_cloud_viewer_tpu.octree.builder import build_octree as jbuild

    rng = np.random.default_rng(17)
    n = 60_000
    batch = JBatch(
        position=rng.random((n, 3)) * np.array([4.0, 4.0, 1.0]),
        attributes={
            "color": rng.integers(0, 256, (n, 3), dtype=np.uint8),
            "intensity": (rng.random(n) * 100).astype(np.float32),
        },
    )
    out = str(tmp_path_factory.mktemp("cloud"))
    jbuild(out, 0.001, batch)
    return out


_BUILDS = [
    ("xray", {}, []),
    ("colored", {}, []),
    ("colored_with_intensity", {"min_intensity": 1.0, "max_intensity": 100.0},
     ["--min_intensity", "1", "--max_intensity", "100"]),
    ("colored_with_height_stddev", {"max_stddev": 0.5},
     ["--max_stddev", "0.5"]),
    ("colored", {"binning": ("intensity", 10.0)},
     ["--binning", "intensity=10"]),
]


def _build_id(build):
    return build[0] + ("_binned" if "binning" in build[1] else "")


@pytest.mark.parametrize("build", _BUILDS, ids=_build_id)
def test_build_xray_quadtree_matches_jax(cloud_dir, tmp_path, build):
    """tests/test_xray.py's build (64 px tiles at 0.05 m) through the port's
    build_xray_quadtree, splat and filter on CPU tensors, and through its
    numpy route with the host filter, byte-equal to the JAX package's host
    build.  One client worker each, so points arrive in one order and
    full-f64 height sums are comparable."""
    from point_cloud_viewer_tpu.query.client import (
        PointCloudClient as JClient)
    from point_cloud_viewer_tpu.xray.build import (
        XrayParameters as JParams, build_xray_quadtree as jxray)
    from point_cloud_viewer_tpu_torch.query.client import PointCloudClient
    from point_cloud_viewer_tpu_torch.xray.build import (
        XrayParameters, build_xray_quadtree)

    kind, kwargs, _ = build
    want = str(tmp_path / "jax")
    jxray(kind, JParams(want, JClient.from_locations([cloud_dir],
                                                     num_threads=1),
                        tile_size_px=64, pixel_size_m=0.05),
          strategy_kwargs=dict(kwargs), num_threads=2)
    for route, client_kwargs, device in (
            ("cpu", {"device": "cpu"}, "cpu"),
            ("host", {"device_filter": False}, None)):
        out = str(tmp_path / route)
        stats = {}
        meta = build_xray_quadtree(
            kind, XrayParameters(out, PointCloudClient.from_locations(
                [cloud_dir], num_threads=1, **client_kwargs),
                tile_size_px=64, pixel_size_m=0.05),
            strategy_kwargs=dict(kwargs, device=device), num_threads=2,
            stats=stats)
        assert_dirs_byte_equal(want, out, context=f"{kind} {route}")
        assert stats["tiles"] == len(meta.nodes) == len(os.listdir(out)) - 1
        assert stats["points"] == 60_000 and stats["leaf_tiles"] == 4


@pytest.mark.parametrize("build", _BUILDS, ids=_build_id)
def test_cli_matches_jax_cli(cloud_dir, tmp_path, monkeypatch, build):
    """The port's cli.build_xray_quadtree with --device cpu, and with
    --no-use_device --no-device_filter, writes the JAX CLI's directory byte
    for byte (both CLIs give the client cpus // tile threads workers: 1
    here)."""
    from point_cloud_viewer_tpu.cli.build_xray_quadtree import main as jcli
    from point_cloud_viewer_tpu_torch.cli.build_xray_quadtree import main

    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    kind, _, flags = build
    common = [cloud_dir, "--coloring_strategy", kind, "--tile_size", "64",
              "--resolution", "0.05", "--num_threads", "2", *flags]
    want = str(tmp_path / "jax")
    assert jcli([*common, "--output_directory", want]) == 0
    for route, extra in (("cpu", ["--device", "cpu"]),
                         ("host", ["--no-use_device", "--no-device_filter"])):
        out = str(tmp_path / route)
        stats = {}
        assert main([*common, "--output_directory", out, *extra],
                    stats=stats) == 0
        assert_dirs_byte_equal(want, out, context=f"{kind} {route}")
        assert stats["points"] == 60_000


def test_cli_raises_without_a_card_unless_asked(cloud_dir, tmp_path,
                                                monkeypatch):
    """With torch seeing no card, the CLI's defaults raise, as do each of
    --no-use_device and --no-device_filter alone (the other still asks for
    CUDA); it never carries on on the CPU by itself."""
    from point_cloud_viewer_tpu_torch.cli.build_xray_quadtree import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    common = [cloud_dir, "--tile_size", "64", "--resolution", "0.05"]
    for i, extra in enumerate(([], ["--no-use_device"],
                               ["--no-device_filter"])):
        with pytest.raises(RuntimeError, match="is_available"):
            main([*common, "--output_directory", str(tmp_path / str(i)),
                  *extra])
    assert main([*common, "--output_directory", str(tmp_path / "host"),
                 "--no-use_device", "--no-device_filter"]) == 0
