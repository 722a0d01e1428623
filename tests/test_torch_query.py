"""The port's per-point query filter (query/device_filter.py,
math/s2_device.py, math/web_mercator_device.py) on CPU tensors, against
the JAX package's point_filter_mask and the host contains() masks.  Inputs
are made from seeds with numpy; every comparison is bit-equality.

The JAX package's OBB and frustum masks are bit-equal to the host only
away from the faces (its `p @ rot_t + translation` rounds unlike numpy's
BLAS); on face points the port is held to the host alone, and the JAX
package's count of differing points is printed, not asserted."""

import os

import numpy as np
import pytest
import torch
from jax._src.config import enable_x64

import point_cloud_viewer_tpu.math.geometry as JG
import point_cloud_viewer_tpu.math.s2 as JS2
import point_cloud_viewer_tpu.math.web_mercator as JWM
import point_cloud_viewer_tpu.math.wgs84 as JW84
import point_cloud_viewer_tpu_torch.math.geometry as PG
import point_cloud_viewer_tpu_torch.math.s2 as PS2
import point_cloud_viewer_tpu_torch.math.web_mercator as PWM
from point_cloud_viewer_tpu.math.intervals import ClosedInterval as JInterval
from point_cloud_viewer_tpu.math.s2_device import _leaf_ids as jax_leaf_ids
from point_cloud_viewer_tpu.query import device_filter as JDF
from point_cloud_viewer_tpu.query.location import AllPoints as JAll
from point_cloud_viewer_tpu.query.location import location_for as jax_loc
from point_cloud_viewer_tpu.s2_cells.cell_union import CellUnion as JUnion
from point_cloud_viewer_tpu_torch import testing
from point_cloud_viewer_tpu_torch.math import s2_device
from point_cloud_viewer_tpu_torch.math.intervals import ClosedInterval
from point_cloud_viewer_tpu_torch.math import web_mercator_device as WMD
from point_cloud_viewer_tpu_torch.math import wgs84
from point_cloud_viewer_tpu_torch.math.web_mercator_device import (
    _calibrated_delta,
    rect_contains_device,
)
from point_cloud_viewer_tpu_torch.ops import _ext
from point_cloud_viewer_tpu_torch.query import device_filter as DF
from point_cloud_viewer_tpu_torch.query.location import AllPoints
from point_cloud_viewer_tpu_torch.query.location import location_for
from point_cloud_viewer_tpu_torch.s2_cells.cell_union import CellUnion

KINDS = ["all", "box", "obb", "frustum", "cell_union", "web_mercator"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensor ops: one intra-op thread beside the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _uniform_points(n=50_000):
    """tests/test_device_filter.py's `points` fixture."""
    return np.random.default_rng(31).random((n, 3)) * 40.0 - 20.0


def _earth_points(n, seed):
    """tests/test_device_filter.py's _earth_points: all six S2 faces in the
    WGS84 radius band, plus face-boundary directions and poles."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    special = np.array([
        [1.0, 1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 1.0],
        [1.0, 1.0, 1.0], [-1.0, -1.0, -1.0],
        [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
        [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0],
    ]) * 6.37e6
    return np.concatenate([d * rng.uniform(6.35e6, 6.39e6, (n, 1)), special])


def _rect(WM):
    return WM.WebMercatorRect(WM.WebMercatorCoord(np.array([0.52, 0.30])),
                              WM.WebMercatorCoord(np.array([0.55, 0.33])))


def _rect_interior_points(n, pad=0.1):
    """ECEF points whose projection falls inside _rect."""
    rng = np.random.default_rng(3)
    rect = _rect(JWM)
    nw, se = rect.north_west.normalized, rect.south_east.normalized
    uv = nw + (se - nw) * (pad + (1 - 2 * pad) * rng.random((n, 2)))
    lat, lon = JWM.web_mercator_to_lat_lng(uv)
    return JW84.geodetic_to_ecef(lat, lon, rng.uniform(-100, 5000, n))


def _geometry(G, kind):
    """tests/test_device_filter.py's box, OBB and frustum, built by the
    geometry module G of either package."""
    if kind == "box":
        return G.Aabb(np.array([-5.0, -3.0, -8.0]), np.array([7.0, 9.0, 2.0]))
    if kind == "obb":
        return G.Obb(G.Isometry.from_axis_angle(
            [1, 1, 0], 0.7, translation=[1.0, -2.0, 3.0]),
            np.array([6.0, 4.0, 9.0]))
    eye = G.Isometry.from_axis_angle([0, 1, 0], 0.4,
                                     translation=[0.0, 0.0, 30.0])
    return G.Frustum.new(eye, G.Perspective.from_fov(1.1, 0.9, 1.0, 60.0))


def _case(kind):
    """-> (points, port location, JAX location) for a query kind."""
    if kind == "all":
        return _uniform_points(), AllPoints(), JAll()
    if kind in ("box", "obb", "frustum"):
        return (_uniform_points(), location_for(_geometry(PG, kind)),
                jax_loc(_geometry(JG, kind)))
    if kind == "cell_union":
        pts = _earth_points(30_000, seed=7)
        ids = [int(c) for c in JS2.parent(
            JS2.leaf_cell_ids_from_points(pts[:5]), 6)]
        return pts, CellUnion(ids), JUnion(ids)
    pts = np.concatenate([_rect_interior_points(2_000),
                          _earth_points(20_000, seed=5)])
    return pts, location_for(_rect(PWM)), jax_loc(_rect(JWM))


def _intervals(n, seed):
    """An intensity attribute and its interval, in each package's type."""
    values = (np.random.default_rng(seed).random(n) * 100.0).astype(
        np.float32)
    return ({"intensity": values}, {"intensity": ClosedInterval(20.0, 60.0)},
            {"intensity": JInterval(20.0, 60.0)})


@pytest.mark.parametrize("with_intervals", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_mask_matches_jax_and_host(kind, with_intervals):
    pts, loc, jloc = _case(kind)
    attrs, ivs, jivs = (_intervals(len(pts), 5) if with_intervals
                        else ({}, None, None))
    stats = DF.FilterStats()
    got = DF.point_filter_mask(loc, pts, intervals=ivs, attributes=attrs,
                               device="cpu", stats=stats)
    host = loc.contains(pts)
    jax_host = jloc.contains(pts)
    if with_intervals:
        host = host & ivs["intensity"].contains(attrs["intensity"])
        jax_host = jax_host & jivs["intensity"].contains(attrs["intensity"])
    np.testing.assert_array_equal(host, jax_host)
    assert got.dtype == bool and got.shape == (len(pts),)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(
        got, JDF.point_filter_mask(jloc, pts, intervals=jivs,
                                   attributes=attrs))
    if kind != "all":
        assert 0 < host.sum() < len(pts), "degenerate fixture"
    assert stats.rows == (0 if kind == "all" and not with_intervals
                          else len(pts))


@pytest.mark.parametrize("n", [1, 3, 511, 512, 513, 700])
def test_padding_boundaries_bit_equal(n):
    """tests/test_device_filter.py's padding sizes (the JAX package pads to
    powers of two; the port does not pad)."""
    pts = _uniform_points()[:n]
    attrs, ivs, jivs = _intervals(n, 11)
    for kind in ("box", "obb", "frustum"):
        loc, jloc = location_for(_geometry(PG, kind)), jax_loc(
            _geometry(JG, kind))
        host = loc.contains(pts) & ivs["intensity"].contains(
            attrs["intensity"])
        got = DF.point_filter_mask(loc, pts, intervals=ivs, attributes=attrs,
                                   device="cpu")
        assert got.shape == (n,)
        np.testing.assert_array_equal(got, host)
        np.testing.assert_array_equal(
            got, JDF.point_filter_mask(jloc, pts, intervals=jivs,
                                       attributes=attrs))


def test_leaf_ids_match_jax_on_all_faces():
    """Ids on all six faces, argmax ties (|x| == |y|, |y| == |z|,
    |x| == |z|), cube diagonals and axes; faces 4-5 set bit 63."""
    pts = np.concatenate([testing.s2_face_points(40_000, seed=2),
                          _earth_points(20_000, seed=3)])
    got = s2_device.leaf_ids(torch.from_numpy(pts)).numpy().view(np.uint64)
    with enable_x64(True):
        want = np.asarray(jax_leaf_ids(np.asarray(pts)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, PS2.leaf_cell_ids_from_points(pts))
    faces = (got >> np.uint64(61)).astype(int)
    assert sorted(set(faces)) == list(range(6))
    assert (got >= np.uint64(1 << 63)).sum() > 1000
    a = np.abs(pts)
    assert ((a[:, 0] == a[:, 1]) | (a[:, 1] == a[:, 2])).sum() > 10_000


def test_uv_to_st_on_the_cpu_is_the_hosts():
    """The quadratic ST reprojection on CPU tensors equals the host's
    s2.uv_to_st bit for bit on 1,000,000 seeded u in [-1, 1] (PyTorch's
    CPU f64 sqrt is one ulp off on some of them, so the port takes numpy's
    there), and so does st_to_ij."""
    u = np.random.default_rng(21).uniform(-1.0, 1.0, (500_000, 2))
    got = s2_device._uv_to_st(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, PS2.uv_to_st(u))
    np.testing.assert_array_equal(
        s2_device._st_to_ij(torch.from_numpy(got)).numpy(),
        PS2.st_to_ij(PS2.uv_to_st(u)))


def test_cell_union_with_bit63_ranges():
    """A union of face 4's level-0 cell, level-8 and level-14 cells on face
    5 and a level-8 cell on face 0: range ends with and without bit 63."""
    pts = testing.s2_face_points(30_000, seed=6)
    leaves = PS2.leaf_cell_ids_from_points(pts)
    face = leaves >> np.uint64(61)
    on5 = leaves[face == 5]
    ids = [(4 << 61) | (1 << 60)]
    ids += [int(c) for c in PS2.parent(on5[:3], 8)]
    ids += [int(c) for c in PS2.parent(on5[3:6], 14)]
    ids += [int(PS2.parent(leaves[face == 0][:1], 8)[0])]
    union = CellUnion(ids)
    assert (union._range_min >= np.uint64(1 << 63)).any()
    assert (union._range_max < np.uint64(1 << 63)).any()
    host = union.contains(pts)
    got = DF.point_filter_mask(union, pts, device="cpu")
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, JUnion(ids).contains(pts))
    np.testing.assert_array_equal(
        got, JDF.point_filter_mask(JUnion(ids), pts))
    assert 0 < host.sum() < len(pts)


def _face_points(kind, n, seed):
    g = _geometry(PG, kind)
    make = (testing.obb_face_points if kind == "obb"
            else testing.frustum_plane_points)
    return g, make(g, n, seed)


@pytest.mark.parametrize("kind", ["obb", "frustum"])
def test_face_points_match_host(kind):
    """100,000 points on the faces (most exactly on one, the rest a few
    ulps to 1e-7 off it): the port equals the host mask; the JAX package's
    mismatch count is printed."""
    g, pts = _face_points(kind, 100_000, seed=13)
    loc = location_for(g)
    host = loc.contains(pts)
    stats = DF.FilterStats()
    got = DF.point_filter_mask(loc, pts, device="cpu", stats=stats)
    np.testing.assert_array_equal(got, host)
    assert 0 < host.sum() < len(pts)
    assert 0 < stats.uncertain < len(pts) and stats.refined == len(pts)
    jax_diff = int((JDF.point_filter_mask(
        jax_loc(_geometry(JG, kind)), pts) != host).sum())
    print(f"{kind}: the JAX package's mask differs from the host in "
          f"{jax_diff} of {len(pts)} face points")


def _reordered_affine(p, m_t, b):
    """p @ m_t + b summed in another order: z and y terms first, then b,
    then the x term."""
    out = p[:, 2:3] * m_t[2] + p[:, 1:2] * m_t[1]
    return (out + b) + p[:, 0:1] * m_t[0]


@pytest.mark.parametrize("kind", ["obb", "frustum"])
def test_band_restores_host_mask_under_another_rounding(kind, monkeypatch):
    """With the device-side transform summed in another order, its raw mask
    differs from the host's on face points; every row the band calls
    definitely in or out agrees with the host, and the refined mask
    equals it."""
    g, pts = _face_points(kind, 60_000, seed=17)
    host = g.contains(pts)
    p = torch.from_numpy(pts)
    if kind == "obb":
        iso = g.obb_from_query
        args = (torch.from_numpy(iso.rotation.T.copy()),
                torch.from_numpy(iso.translation))
        raw = (_reordered_affine(p, *args).abs()
               <= torch.from_numpy(g.half_extent)).all(dim=1).numpy()
        classify = lambda: DF._obb_classify(  # noqa: E731
            p, *args, torch.from_numpy(g.half_extent))
    else:
        m = torch.from_numpy(g.clip_from_query)
        qw = _reordered_affine(p, m[:, :3].T, m[:, 3])
        clip = qw[:, :3] / qw[:, 3:]
        raw = ((clip > -1.0) & (clip < 1.0)).all(dim=1).numpy()
        classify = lambda: DF._frustum_classify(p, m)  # noqa: E731
    assert (raw != host).sum() > 100
    monkeypatch.setattr(DF, "_affine", _reordered_affine)
    definite_in, uncertain = (t.numpy() for t in classify())
    definite_out = ~definite_in & ~uncertain
    assert host[definite_in].all() and not host[definite_out].any()
    assert definite_in.sum() > 1000 and definite_out.sum() > 1000
    got = DF.point_filter_mask(location_for(g), pts, device="cpu")
    np.testing.assert_array_equal(got, host)


def test_non_finite_rows_go_to_the_host():
    """NaN and infinite coordinates land in the band; the host decides."""
    pts = _uniform_points(2_000)
    pts[::7, 1] = np.nan
    pts[3::11, 0] = np.inf
    pts[5::13, 2] = -np.inf
    for kind in ("obb", "frustum"):
        loc = location_for(_geometry(PG, kind))
        with np.errstate(invalid="ignore"):
            host = loc.contains(pts)
            got = DF.point_filter_mask(loc, pts, device="cpu")
        np.testing.assert_array_equal(got, host)


def test_calibrated_delta_on_the_cpu():
    assert 1e-9 <= _calibrated_delta(torch.device("cpu")) < 1e-6


def test_web_mercator_boundary_band_bit_equal():
    """tests/test_device_filter.py's boundary band: points on the rect's
    edges and 1e-12 either side, through rect_contains_device and the
    filter."""
    rect = _rect(PWM)
    nw, se = rect.north_west.normalized, rect.south_east.normalized
    rng = np.random.default_rng(17)
    us = np.concatenate([np.repeat([nw[0], se[0]], 40),
                         rng.uniform(nw[0], se[0], 80)])
    vs = np.concatenate([rng.uniform(nw[1], se[1], 80),
                         np.repeat([nw[1], se[1]], 40)])
    for nudge in (0.0, 1e-12, -1e-12):
        lat, lon = JWM.web_mercator_to_lat_lng(
            np.stack([us + nudge, vs], axis=-1))
        pts = JW84.geodetic_to_ecef(lat, lon, 0.0)
        host = rect.contains(pts)
        np.testing.assert_array_equal(
            rect_contains_device(rect, pts, device="cpu"), host)
        np.testing.assert_array_equal(
            DF.point_filter_mask(location_for(rect), pts, device="cpu"),
            host)


def test_host_only_queries_return_none():
    """A custom location type, a missing, non-scalar or non-numeric filter
    attribute and an empty cell union go to the host path (None), as in
    the JAX package; the host path then raises as it does there."""
    from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
    from point_cloud_viewer_tpu_torch.query.point_query import PointQuery

    class CustomLocation:
        def contains(self, p):
            return np.ones(len(p), dtype=bool)

        def intersects_aabbs(self, corners):
            return np.ones(len(corners), dtype=bool)

    pts = _uniform_points(100)
    loc = location_for(_geometry(PG, "box"))
    assert DF.point_filter_mask(CustomLocation(), pts, device="cpu") is None
    assert DF.point_filter_mask(CellUnion([]), pts, device="cpu") is None
    for attrs in ({}, {"v": np.zeros((100, 3))},
                  {"v": np.array(["a"] * 100)}):
        assert DF.point_filter_mask(
            loc, pts, intervals={"v": ClosedInterval(0.0, 1.0)},
            attributes=attrs, device="cpu") is None
    query = PointQuery(attributes=[], location=_geometry(PG, "box"),
                       filter_intervals={"v": ClosedInterval(0.0, 1.0)})
    with pytest.raises(KeyError):
        query.filter_batch(PointsBatch(position=pts), use_device=True,
                           device="cpu")


def test_cuda_without_a_card_raises(monkeypatch):
    """The filter asks for CUDA by default and never falls back to the CPU:
    without a card, the mask and the client raise; the host path runs."""
    from point_cloud_viewer_tpu_torch.query.client import PointCloudClient

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loc = location_for(_geometry(PG, "obb"))
    with pytest.raises(RuntimeError, match="is_available"):
        DF.point_filter_mask(loc, _uniform_points(10))
    with pytest.raises(RuntimeError, match="is_available"):
        PointCloudClient([])
    assert PointCloudClient([], device_filter=False).device is None


# --- K8's route, rehearsed on the CPU -----------------------------------------


def test_k8_struct_matches_the_kernel_source():
    """_ext's layout of K8's argument struct is csrc/query_mask.cu's."""
    import re

    src = open(os.path.join(_ext.CSRC, "query_mask.cu")).read()
    region = int(re.search(r"kMaskRegion = (\d+);", src).group(1))
    most = int(re.search(r"kMaskMaxIntervals = (\d+);", src).group(1))
    assert most == _ext.QUERY_MASK_MAX_INTERVALS == 8
    assert region + 2 * most == _ext.QUERY_MASK_PARAMS


@pytest.mark.parametrize("kind", testing.QUERY_MASK_KINDS)
def test_k8_params_pack_the_geometry(kind):
    """Each region's constants and the intervals' bounds land where
    csrc/query_mask.cu's MaskParams reads them; the rest is zero."""
    g = testing.query_mask_region(kind)
    lows, highs = [1.5, -2.0, 3.0], [4.5, 7.0, 3.0]
    params = DF._k8_params(type(g), g, lows, highs, delta=1e-9)
    assert params.dtype == np.float64
    assert params.shape == (_ext.QUERY_MASK_PARAMS,)
    region, lo, hi = params[:16], params[16:24], params[24:]
    np.testing.assert_array_equal(lo, lows + [0.0] * 5)
    np.testing.assert_array_equal(hi, highs + [0.0] * 5)
    if kind == "box":
        np.testing.assert_array_equal(region[:3], g.mins)
        np.testing.assert_array_equal(region[3:6], g.maxs)
        assert not region[6:].any()
    elif kind == "obb":
        iso = g.obb_from_query
        np.testing.assert_array_equal(region[:9].reshape(3, 3),
                                      iso.rotation.T)
        np.testing.assert_array_equal(region[9:12], iso.translation)
        np.testing.assert_array_equal(region[12:15], g.half_extent)
        assert region[15] == 0.0
    elif kind == "frustum":
        np.testing.assert_array_equal(region.reshape(4, 4),
                                      g.clip_from_query)
    else:
        nw, se = g.north_west.normalized, g.south_east.normalized
        np.testing.assert_array_equal(
            region[:8], np.concatenate([nw + 1e-9, se - 1e-9, nw - 1e-9,
                                        se + 1e-9]))
        np.testing.assert_array_equal(region[8:], [
            wgs84.SEMI_MAJOR_M, wgs84.SEMI_MINOR_M,
            wgs84.ECC2_SQ * wgs84.SEMI_MINOR_M,
            wgs84.ECC_SQ * wgs84.SEMI_MAJOR_M, PWM.LAT_BOUND_RAD,
            2.0 * np.pi, 0.25 / np.pi, 0.0])


def _model_codes(kind, params, k, values):
    """csrc/query_mask.cu's codes on CPU tensors, read from the packed
    struct alone: bit 0 definitely in, bit 1 uncertain, each within every
    interval."""
    n = values.shape[0] // (3 + k)
    p = torch.from_numpy(values[:3 * n].reshape(n, 3))
    r = torch.from_numpy(params[:16])
    uncertain = torch.zeros(n, dtype=torch.bool)
    if kind == 0:
        keep = DF._box_mask(p, r[:3], r[3:6])
    elif kind == 1:
        keep, uncertain = DF._obb_classify(p, r[:9].view(3, 3), r[9:12],
                                           r[12:15])
    elif kind == 2:
        keep, uncertain = DF._frustum_classify(p, r.view(4, 4))
    else:
        np.testing.assert_array_equal(params[8:16], WMD.wmc_consts())
        m = WMD._wmc_project(p)
        keep = ((m >= r[0:2]) & (m < r[2:4])).all(dim=-1)
        out = ((m < r[4:6]) | (m >= r[6:8])).any(dim=-1)
        uncertain = ~(keep | out)
    cols = torch.from_numpy(values[3 * n:].reshape(k, n))
    im = DF._interval_mask(cols, torch.from_numpy(params[16:16 + k]),
                           torch.from_numpy(params[24:24 + k]))
    return ((keep & im).to(torch.uint8)
            | ((uncertain & im).to(torch.uint8) << 1)).numpy()


class _Recorder:
    """Stands in for _ext.lib() on the CPU: records each pcv_query_mask
    call and answers it with _model_codes."""

    def __init__(self):
        self.calls = []

    def pcv_query_mask(self, kind, params, k, n, host_in, dev_in, dev_codes,
                       host_codes, stream):
        import ctypes

        params = np.ctypeslib.as_array(
            (ctypes.c_double * _ext.QUERY_MASK_PARAMS).from_address(params))
        values = np.ctypeslib.as_array(
            (ctypes.c_double * ((3 + k) * n)).from_address(host_in))
        codes = np.ctypeslib.as_array(
            (ctypes.c_uint8 * n).from_address(host_codes))
        codes[:] = _model_codes(kind, params.copy(), k, values.copy())
        self.calls.append((kind, k, n))
        return 0


class _CpuStaging(DF._Staging):
    """_Staging with its buffers on the CPU and no stream."""

    def __init__(self, dev):
        self.dev = dev
        self.values = self.rows = 0
        self.host_in = self.dev_in = self.host_codes = self.dev_codes = None

    def reserve(self, values, rows):
        if values > self.values:
            self.host_in = torch.empty(values, dtype=torch.float64)
            self.dev_in = torch.empty(values, dtype=torch.float64)
            self.values = values
        if rows > self.rows:
            self.host_codes = torch.empty(rows, dtype=torch.uint8)
            self.dev_codes = torch.empty(rows, dtype=torch.uint8)
            self.rows = rows

    def stream_ptr(self):
        return 0


@pytest.fixture
def k8_on_the_cpu(monkeypatch):
    """`device="cuda"` resolved without a card: K8's entry is the recorder,
    its staging lives on the CPU, and the eager route runs on CPU tensors
    (its calls are counted)."""
    import contextlib

    recorder = _Recorder()
    recorder.eager = 0
    eager = DF._eager_classes

    def eager_on_the_cpu(*args):
        recorder.eager += 1
        return eager(*args[:-1], torch.device("cpu"))

    monkeypatch.setattr(DF, "resolve_device", torch.device)
    monkeypatch.setattr(DF, "_Staging", _CpuStaging)
    monkeypatch.setattr(DF, "_staging_free", {})
    monkeypatch.setattr(DF, "_eager_classes", eager_on_the_cpu)
    monkeypatch.setattr(DF, "_calibrated_delta", lambda dev, fused=False:
                        _calibrated_delta(torch.device("cpu")))
    monkeypatch.setattr(_ext, "lib", lambda: recorder)
    monkeypatch.setattr(_ext, "device_guard",
                        lambda t: contextlib.nullcontext())
    return recorder


def _counted(fn):
    """fn() under a profiler session -> (its result, the mask counters)."""
    from torch.profiler import ProfilerActivity, profile

    from point_cloud_viewer_tpu_torch.utils import progress

    progress.reset_span_totals()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    totals = progress.span_totals()
    progress.reset_span_totals()
    return out, tuple(totals.get(f"query.mask.{route}", [0])[0]
                      for route in ("fused", "eager"))


@pytest.mark.parametrize("with_intervals", [False, True])
@pytest.mark.parametrize("kind", testing.QUERY_MASK_KINDS)
def test_k8_route_calls_the_entry_once_a_node(k8_on_the_cpu, kind,
                                              with_intervals):
    """The four regions on a card take K8: one pcv_query_mask a node, the
    fused counter a node, and the host's mask after the refinement."""
    nodes = [testing.query_mask_case(kind, n, seed=n,
                                     with_intervals=with_intervals)
             for n in (1, 3_001, 20_000)]

    def mask_all():
        return [DF.point_filter_mask(*node, device="cuda") for node in nodes]

    got, counted = _counted(mask_all)
    assert counted == (3, 0)
    k = 2 if with_intervals else 0
    code = testing.QUERY_MASK_KINDS.index(kind)
    assert k8_on_the_cpu.calls == [(code, k, 1), (code, k, 3_001),
                                   (code, k, 20_000)]
    assert k8_on_the_cpu.eager == 0
    for mask, node in zip(got, nodes):
        np.testing.assert_array_equal(mask, testing.query_mask_host(*node))


def test_k8_route_leaves_unions_the_cpu_and_nine_intervals_eager(
        k8_on_the_cpu):
    """Cell unions and nine intervals on a card, and every region on the
    CPU, keep the eager ops: no pcv_query_mask call, the eager counter a
    node."""
    pts = _earth_points(3_000, seed=7)
    ids = [int(c) for c in PS2.parent(
        PS2.leaf_cell_ids_from_points(pts[:5]), 6)]
    union = CellUnion(ids)
    loc, box_pts, _, _ = testing.query_mask_case("box", 3_000, seed=3)
    nine = {f"v{i}": ClosedInterval(0.5 * i, 5.0 + 0.5 * i)
            for i in range(9)}

    def columns(n):
        values = np.random.default_rng(n).random(n) * 10.0
        return {name: values for name in nine}

    calls = [(union, pts, {}, {}, "cuda"),
             (union, pts, nine, columns(len(pts)), "cuda"),
             (loc, box_pts, nine, columns(len(box_pts)), "cuda")]
    calls += [(*testing.query_mask_case(kind, 2_000, seed=1,
                                        with_intervals=True), "cpu")
              for kind in testing.QUERY_MASK_KINDS]

    def mask_all():
        return [DF.point_filter_mask(*c[:4], device=c[4]) for c in calls]

    got, counted = _counted(mask_all)
    assert counted == (0, len(calls))
    assert k8_on_the_cpu.calls == []
    assert k8_on_the_cpu.eager == len(calls)
    for mask, c in zip(got, calls):
        np.testing.assert_array_equal(mask, testing.query_mask_host(*c[:4]))


# --- K8 on the client's nodes as stored, rehearsed on the CPU -----------------

# csrc/query_mask.cu ColumnType -> the column's stored dtype.
_COLUMN_DTYPES = {0: "<f8", 1: "<f4", 2: "u1", 3: "<u2", 4: "<u4", 5: "i1",
                  6: "<i2", 7: "<i4"}


def _model_decode(raw, encoding, fma, cube):
    """csrc/query_mask.cu EncodedRows on the host: numpy's expression, or
    with `fma` the host's own native routine (the contracted multiply-add
    that the card mirrors)."""
    from point_cloud_viewer_tpu_torch import native
    from point_cloud_viewer_tpu_torch.ops.codec import PositionEncoding

    enc = raw.view(PositionEncoding(encoding).numpy_dtype).reshape(-1, 3)
    if fma:
        return native.decode_positions(enc, cube[:3], cube[3])
    t = enc.astype(np.float64)
    if encoding in (1, 2):
        t = t / (255.0 if encoding == 1 else 65535.0)
    return t * cube[3] + cube[:3]


def _from(address, ctype, count):
    import ctypes

    return np.ctypeslib.as_array((ctype * count).from_address(address))


def _record_decode_mask(recorder, kind, params, k, encoding, fma, node, cols,
                        n, in_bytes, host_in, dev_in, dev_out, host_out,
                        scratch, stream):
    """pcv_query_decode_mask on the CPU: the staged node decoded and
    classified by the models above, its nonzero codes compacted in row
    order into host_out's layout."""
    import ctypes

    params = _from(params, ctypes.c_double, _ext.QUERY_MASK_PARAMS).copy()
    cube = _from(node, ctypes.c_double, 4).copy()
    specs = _from(cols, ctypes.c_longlong, max(2 * k, 1)).copy()
    raw = _from(host_in, ctypes.c_uint8, in_bytes).copy()
    assert not _from(scratch, ctypes.c_longlong,
                     DF._decode_scratch(n)).any()
    bpc = (1, 2, 4, 8)[encoding - 1]
    pos = _model_decode(raw[:3 * n * bpc], encoding, fma, cube)
    columns = []
    for j in range(k):
        dtype = np.dtype(_COLUMN_DTYPES[int(specs[2 * j])])
        at = int(specs[2 * j + 1])
        assert at % 16 == 0 and at >= 3 * n * bpc
        columns.append(raw[at:at + n * dtype.itemsize].view(dtype)
                       .astype(np.float64))
    values = np.concatenate([pos.ravel(), *columns])
    codes = _model_codes(kind, params, k, values)
    rows = np.flatnonzero(codes)
    at_pos, at_rows, at_codes, size = DF._decode_layout(n)
    out = _from(host_out, ctypes.c_uint8, size)
    out[:8] = np.array([len(rows)], dtype=np.int64).view(np.uint8)
    out[at_pos:at_pos + 24 * len(rows)] = pos[rows].view(np.uint8).ravel()
    out[at_rows:at_rows + 4 * len(rows)] = rows.astype(np.int32).view(
        np.uint8)
    out[at_codes:at_codes + len(rows)] = codes[rows]
    recorder.decoded.append({"kind": kind, "k": k, "encoding": encoding,
                             "fma": fma, "n": n, "cube": cube,
                             "types": [int(t) for t in specs[:2 * k:2]]})
    return 0


def _read_node_files(recorder, count, staged, paths, expect, buf0, cap0,
                     buf1, cap1, out):
    """pcv_read_node_files on the CPU: the same layout and return codes."""
    import ctypes
    import errno

    recorder.reads.append(count)
    expect = _from(expect, ctypes.c_longlong, count).tolist()
    out = _from(out, ctypes.c_longlong, 2 * count + 2)
    offsets, need = DF._layout(expect, staged)
    out[count:2 * count] = offsets
    out[2 * count:] = need
    if need[0] > cap0 or need[1] > cap1:
        return 1
    status = 0
    for i, path in enumerate(paths.split(b"\0")[:count]):
        try:
            data = open(path, "rb").read()
        except FileNotFoundError:
            out[i] = -1
            return -errno.ENOENT
        out[i] = len(data)
        slot = DF._aligned(expect[i] + 1)
        if len(data) >= slot:
            status = 1
        ctypes.memmove((buf0 if i < staged else buf1) + offsets[i], data,
                       min(len(data), slot))
    return status


@pytest.fixture
def node_decode_on_the_cpu(k8_on_the_cpu, monkeypatch):
    """k8_on_the_cpu with pcv_query_decode_mask recorded too (`decoded`)
    and pcv_read_node_files read with Python (`reads`: files a call)."""
    import functools

    k8_on_the_cpu.decoded = []
    k8_on_the_cpu.reads = []
    k8_on_the_cpu.pcv_query_decode_mask = functools.partial(
        _record_decode_mask, k8_on_the_cpu)
    k8_on_the_cpu.pcv_read_node_files = functools.partial(_read_node_files,
                                                          k8_on_the_cpu)
    # _Staging's node buffers on the CPU; _CpuStaging's __init__ leaves
    # them unset.
    monkeypatch.setattr(_CpuStaging, "_pair", lambda self, nbytes: (
        torch.empty(nbytes, dtype=torch.uint8),
        torch.empty(nbytes, dtype=torch.uint8)), raising=False)
    monkeypatch.setattr(_CpuStaging, "_zeroed", lambda self, words:
                        torch.zeros(words, dtype=torch.int64), raising=False)
    for name in ("node_bytes", "node_rows", "files_bytes"):
        monkeypatch.setattr(_CpuStaging, name, 0, raising=False)
    for name in ("host_node", "dev_node", "host_kept", "dev_kept",
                 "node_view", "kept_view", "host_files", "scratch",
                 "node_args"):
        monkeypatch.setattr(_CpuStaging, name, None, raising=False)
    return k8_on_the_cpu


@pytest.fixture(scope="module")
def decode_octrees(tmp_path_factory):
    """testing.query_decode_octree in each stored encoding."""
    return {enc: testing.query_decode_octree(
        str(tmp_path_factory.mktemp(f"octree_{enc}")), enc)
        for enc in testing.QUERY_DECODE_RESOLUTIONS}


def _decode_query(octree, kind, k, attributes=None):
    from point_cloud_viewer_tpu_torch.query.point_query import PointQuery

    return PointQuery(
        attributes=attributes or ["color", "intensity",
                                  *testing.QUERY_DECODE_COLUMNS],
        location=testing.query_decode_regions(octree)[kind],
        filter_intervals=testing.query_decode_intervals(k))


def _host_node(octree, query, node_id):
    """The host route of a node: read_node_batch, the host masks, retain."""
    batch = octree.points_in_node(node_id, attributes=query.attributes)
    return query.filter_batch(batch, use_device=False)


def _assert_batches_equal(got, want):
    assert got.position.dtype == want.position.dtype == np.float64
    assert got.position.tobytes() == want.position.tobytes()
    assert list(got.attributes) == list(want.attributes)
    for name, values in want.attributes.items():
        assert got.attributes[name].dtype == values.dtype, name
        assert got.attributes[name].shape == values.shape, name
        assert got.attributes[name].tobytes() == values.tobytes(), name


def _decode_counters(fn):
    """fn() under a profiler session -> (its result, the counters
    query.decode.card, query.decode.host, query.mask.fused)."""
    from torch.profiler import ProfilerActivity, profile

    from point_cloud_viewer_tpu_torch.utils import progress

    progress.reset_span_totals()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    totals = progress.span_totals()
    progress.reset_span_totals()
    return out, tuple(totals.get(name, [0])[0] for name in (
        "query.decode.card", "query.decode.host", "query.mask.fused"))


@pytest.mark.parametrize("k", [0, 1, 8])
@pytest.mark.parametrize("kind", testing.QUERY_MASK_KINDS)
@pytest.mark.parametrize("encoding", sorted(testing.QUERY_DECODE_RESOLUTIONS))
def test_node_decode_matches_the_host_route(node_decode_on_the_cpu,
                                            decode_octrees, encoding, kind,
                                            k):
    """Every node of an octree through NodeDecode (the recorder standing in
    for pcv_query_decode_mask): the host route's batch to the bit, one call
    a node with the node's encoding, cube, column types and decode mode,
    and the counters: the host decodes only OBB and frustum nodes with band
    rows."""
    from point_cloud_viewer_tpu_torch.query.device_filter import (
        _host_decode_fused, node_decode)

    octree = decode_octrees[encoding]
    query = _decode_query(octree, kind, k)
    route = node_decode(query, [octree], "cuda")
    assert route is not None and route.takes(octree, False)
    assert not route.takes(octree, True)
    stats = DF.FilterStats()

    def run():
        return [route.node_points(octree, node_id, stats=stats)
                for node_id in octree.node_ids]

    got, (card, host, fused) = _decode_counters(run)
    nodes = len(octree.node_ids)
    assert fused == card + host == nodes
    calls = node_decode_on_the_cpu.decoded
    assert len(calls) == nodes and node_decode_on_the_cpu.calls == []
    banded = 0
    for node_id, batch, call in zip(octree.node_ids, got, calls):
        meta = octree.node_meta(node_id)
        _assert_batches_equal(batch, _host_node(octree, query, node_id))
        assert call["n"] == meta.num_points
        assert call["encoding"] == int(meta.position_encoding)
        assert call["fma"] == int(_host_decode_fused(meta.position_encoding,
                                                     meta.num_points))
        assert call["kind"] == testing.QUERY_MASK_KINDS.index(kind)
        assert call["k"] == k
        np.testing.assert_array_equal(call["cube"], [*meta.cube_min,
                                                     meta.edge_length])
        assert call["types"] == [
            DF._K8_COLUMN[octree.attribute_data_types[m]]
            for m in sorted(query.filter_intervals)]
    if encoding in ("u8", "u16"):
        assert {c["fma"] for c in calls} == {0, 1}
    assert stats.rows == sum(c["n"] for c in calls)
    if kind == "box":
        assert host == 0 and stats.uncertain == 0
    else:
        assert stats.uncertain > 0
        banded = host if kind in ("obb", "frustum") else 0
        assert host == banded and (kind == "web_mercator" or host > 0)


def test_node_decode_keeps_no_row_and_every_row(node_decode_on_the_cpu,
                                                decode_octrees):
    """A box away from the site keeps no row of a node, a box around the
    site every row, each with the host route's attributes."""
    from point_cloud_viewer_tpu_torch.math.geometry import Aabb
    from point_cloud_viewer_tpu_torch.octree.node_id import NodeId
    from point_cloud_viewer_tpu_torch.query.device_filter import node_decode
    from point_cloud_viewer_tpu_torch.query.point_query import PointQuery

    octree = decode_octrees["u16"]
    lo, hi = octree.root_cube.min, octree.root_cube.max()
    for box, kept in ((Aabb(hi + 1.0, hi + 2.0), 0),
                      (Aabb(lo - 1.0, hi + 1.0), 10_004)):
        query = PointQuery(attributes=["color", "intensity"], location=box,
                           filter_intervals=testing.query_decode_intervals(0))
        route = node_decode(query, [octree], "cuda")
        got = route.node_points(octree, NodeId.root())
        assert len(got) == kept
        _assert_batches_equal(got, _host_node(octree, query, NodeId.root()))


def test_node_decode_follows_the_hosts_decode(node_decode_on_the_cpu,
                                              decode_octrees):
    """With the native library switched off the host decodes u8 and u16
    nodes with numpy's expression, and the card is asked for it too."""
    from point_cloud_viewer_tpu_torch import native
    from point_cloud_viewer_tpu_torch.query.device_filter import node_decode

    octree = decode_octrees["u8"]
    query = _decode_query(octree, "obb", 1)
    route = node_decode(query, [octree], "cuda")
    with native.disabled():
        for node_id in octree.node_ids:
            _assert_batches_equal(route.node_points(octree, node_id),
                                  _host_node(octree, query, node_id))
    assert {c["fma"] for c in node_decode_on_the_cpu.decoded} == {0}


def test_node_decode_route_choice(node_decode_on_the_cpu, decode_octrees,
                                  tmp_path):
    """The route takes a card, the four K8 regions, at most 8 intervals on
    fetched attributes of K8's column types, octrees and nodes not fully
    inside; the CPU, cell unions, all points, nine intervals, an interval on
    an attribute not fetched or of another type, and S2 clouds stay on the
    host's decode."""
    from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
    from point_cloud_viewer_tpu_torch.math.intervals import ClosedInterval
    from point_cloud_viewer_tpu_torch.query.device_filter import node_decode
    from point_cloud_viewer_tpu_torch.query.point_query import PointQuery
    from point_cloud_viewer_tpu_torch.s2_cells.container import S2Cells
    from point_cloud_viewer_tpu_torch.s2_cells.splitter import build_s2_cloud

    octree = decode_octrees["f32"]
    names = ["color", "intensity", *testing.QUERY_DECODE_COLUMNS]
    for kind in testing.QUERY_MASK_KINDS:
        assert node_decode(_decode_query(octree, kind, 8), [octree],
                           "cuda") is not None
        assert node_decode(_decode_query(octree, kind, 1), [octree],
                           "cpu") is None
        assert node_decode(_decode_query(octree, kind, 1), [octree],
                           None) is None
    box = testing.query_decode_regions(octree)["box"]
    nine = {m: ClosedInterval(0.0, 1.0) for m in names[1:]}
    assert len(nine) == 9
    pts = octree.points_in_node(octree.node_ids[0], attributes=[]).position
    union = CellUnion([int(c) for c in PS2.parent(
        PS2.leaf_cell_ids_from_points(pts[:3]), 12)])
    for query in (PointQuery(attributes=names, location=union),
                  PointQuery(attributes=names),
                  PointQuery(attributes=names, location=box,
                             filter_intervals=nine),
                  PointQuery(attributes=["color"], location=box,
                             filter_intervals={
                                 "intensity": ClosedInterval(0.0, 1.0)})):
        assert node_decode(query, [octree], "cuda") is None
    s2dir = str(tmp_path / "s2")
    build_s2_cloud(s2dir, PointsBatch(
        position=pts, attributes={"color": np.zeros((len(pts), 3), np.uint8),
                                  "intensity": np.zeros(len(pts),
                                                        np.float32)}))
    cells = S2Cells.from_directory(s2dir)
    query = PointQuery(attributes=["color", "intensity"], location=box,
                       filter_intervals=testing.query_decode_intervals(1))
    route = node_decode(query, [octree, cells], "cuda")
    assert route.takes(octree, False)
    assert not route.takes(octree, True) and not route.takes(cells, False)
    u64 = PointQuery(attributes=names, location=box, filter_intervals={
        "a_u64": ClosedInterval(10.0, 90.0)})
    assert not node_decode(u64, [octree], "cuda").takes(octree, False)


@pytest.mark.parametrize("kind", testing.QUERY_MASK_KINDS)
def test_client_on_the_card_decode_streams_the_host_routes_points(
        node_decode_on_the_cpu, decode_octrees, kind):
    """The client on a card (the recorders standing in for K8's entries):
    the same points as with device_filter=False; every node the route takes
    is decoded through it, fully inside ones by the host, and the counters
    add up to the jobs."""
    from point_cloud_viewer_tpu_torch.math.geometry import Aabb
    from point_cloud_viewer_tpu_torch.query.client import PointCloudClient

    octree = decode_octrees["u16"]
    query = _decode_query(octree, kind, 1, attributes=["color", "intensity"])
    if kind == "box":  # a box around the lowest octant: fully inside nodes
        lo, hi = octree.root_cube.min, octree.root_cube.max()
        query.location = location_for(Aabb(lo - 1.0, (lo + hi) / 2 + 1.0))

    def collect(client):
        got = list(client.stream(query))
        pos = np.concatenate([b.position for b in got])
        col = np.concatenate([b.attributes["color"] for b in got])
        val = np.concatenate([b.attributes["intensity"] for b in got])
        # Rows that decode to one position (u8 nodes) sorted by colour and
        # intensity too: the workers' order is not fixed.
        order = np.lexsort((val, *col.T[::-1], *pos.T[::-1]))
        return pos[order], col[order], val[order]

    want = collect(PointCloudClient([octree], num_threads=2,
                                    device_filter=False))
    client = PointCloudClient([octree], num_threads=2, device="cpu")
    client.device = torch.device("cuda")
    got, (card, host, _) = _decode_counters(lambda: collect(client))
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    jobs = octree.nodes_in_location_ex(query.location)
    fully = sum(f for _, f in jobs)
    assert card + host == len(jobs) > 0
    assert len(node_decode_on_the_cpu.decoded) == len(jobs) - fully
    if kind == "box":
        assert fully > 0 and host == fully


def test_k8_decode_layout_matches_the_kernel_source():
    """The compacting kernel's tile and its output layout are
    device_filter's."""
    import re

    src = open(os.path.join(_ext.CSRC, "query_mask.cu")).read()
    threads = int(re.search(r"kCompactThreads = (\d+);", src).group(1))
    items = int(re.search(r"kCompactItems = (\d+);", src).group(1))
    assert threads * items == _ext.QUERY_DECODE_TILE
    n = 1_000
    assert DF._decode_layout(n) == (16, 16 + 24 * n, 16 + 28 * n,
                                    16 + 29 * n)
    for text in ("out + 16)", "out + 16 + 24 * n)", "out + 16 + 28 * n)"):
        assert text in src
    assert DF._decode_scratch(1) == 3
    assert DF._decode_scratch(_ext.QUERY_DECODE_TILE + 1) == 4
    assert set(DF._K8_COLUMN.values()) == set(_COLUMN_DTYPES)
    for data_type, code in DF._K8_COLUMN.items():
        assert data_type.numpy_dtype == np.dtype(_COLUMN_DTYPES[code])


@pytest.mark.parametrize("n", [1, 1_023, 1_025, 20_001])
@pytest.mark.parametrize("encoding", ["u16", "f32"])
def test_node_decode_of_synthetic_nodes(node_decode_on_the_cpu, tmp_path,
                                        encoding, n):
    """Nodes of n random rows written as node files: the host route's
    batch, twice on one staging set."""
    node, query = testing.query_decode_node(str(tmp_path), encoding, n,
                                            seed=n, share=0.6)
    route = DF.NodeDecode(query, [], torch.device("cuda"))
    want = testing.query_decode_node_host(node, query)
    assert 0 < len(want) < n or n == 1
    for _ in range(2):
        _assert_batches_equal(route.node_points(node, "r"), want)
    assert len(node_decode_on_the_cpu.decoded) == 2


def test_node_decode_reads_a_nodes_files_in_one_call(node_decode_on_the_cpu,
                                                     decode_octrees,
                                                     tmp_path):
    """A directory's node is read by one pcv_read_node_files call of all its
    files (positions, interval columns, the other attributes), and by a
    second where the staging set's buffers were too small for them (a first
    node, files that grew); a missing file raises NodeNotFound, as the host
    route does."""
    import shutil

    from point_cloud_viewer_tpu_torch.io.node_io import NodeNotFound
    from point_cloud_viewer_tpu_torch.octree.octree import Octree
    from point_cloud_viewer_tpu_torch.query.device_filter import node_decode

    octree = decode_octrees["f64"]
    query = _decode_query(octree, "box", 1)
    route = node_decode(query, [octree], "cuda")
    node_id = octree.node_ids[3]
    route.node_points(octree, node_id)
    route.node_points(octree, node_id)
    assert node_decode_on_the_cpu.reads == [2 + 9] * 3
    copy = str(tmp_path / "copy")
    shutil.copytree(octree.data_provider.directory, copy)
    grown = Octree.from_directory(copy)
    grown.attribute_data_types.update(octree.attribute_data_types)
    stem = grown.data_provider.stem(str(node_id))
    for ext, row_bytes in (("xyz", 24), ("rgb", 3), ("intensity", 4)):
        data = open(stem + "." + ext, "rb").read()
        with open(stem + "." + ext, "wb") as f:
            f.write(data + data[:1000 * row_bytes])
    for name in testing.QUERY_DECODE_COLUMNS:
        data = open(stem + "." + name, "rb").read()
        with open(stem + "." + name, "wb") as f:
            f.write(data + data[:len(data) // grown.node_meta(
                node_id).num_points * 1000])
    route = node_decode(query, [grown], "cuda")
    node_decode_on_the_cpu.reads.clear()
    got = route.node_points(grown, node_id)
    assert node_decode_on_the_cpu.reads == [11, 11]
    _assert_batches_equal(got, _host_node(grown, query, node_id))
    os.remove(stem + ".rgb")
    with pytest.raises(NodeNotFound):
        route.node_points(grown, node_id)
    with pytest.raises(NodeNotFound):
        grown.points_in_node(node_id, attributes=query.attributes)
