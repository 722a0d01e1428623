"""The PyTorch port's viewer cull (point_cloud_viewer_tpu_torch/ops/
cull_cuda.py, ops/culling.py) on CPU tensors -- K5's plain version --
against the JAX package: the lax `frustum_cull_lod_select`, the Pallas
kernel in interpret mode, and `DeviceCullSession`.

Tolerances are the JAX package's own between its lax step and its Pallas
kernel (tests/test_culling_pallas.py:42-48): equal visible masks, sizes
and priorities to rtol 1e-5, atol 1e-6 (f32, the einsum associates the
projections differently), -inf wherever a node is not visible.  Orders
are compared as priority sequences (ties may permute).  Within the port,
multi-frame and single-frame results are bit-equal (tolerance 0).

A PyTorch model of the CUDA kernel's rules (csrc/cull.cu: inert axes
dropped, two extreme corners an axis with the 8-corner fallback, the
screen size from shared products) is held to `cull_lod_plain` bit for bit
(NaN matching NaN) under hypothesis, over IEEE corner cases; a model
without the fallback fails.

The host prep's `math.sat.dedup_axes`, one vectorised pass in the port, is
held byte for byte to the JAX package's loop: frustum, Obb and orbit axis
sets, squared distances at eps, a sum whose order decides, a greedy chain
and non-finite rows.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
from point_cloud_viewer_tpu.math import sat as jax_sat
from point_cloud_viewer_tpu.math.geometry import (
    Frustum, Isometry, Obb, Perspective)
from point_cloud_viewer_tpu.ops import culling as jax_culling
from point_cloud_viewer_tpu.ops.culling_pallas import (
    frustum_cull_lod_select_pallas,
)
from point_cloud_viewer_tpu_torch.math import sat as port_sat
from point_cloud_viewer_tpu_torch.ops import cull_cuda
from point_cloud_viewer_tpu_torch.ops import culling

RTOL, ATOL = 1e-5, 1e-6


def _table(k, seed, levels=12, span=500.0, offset=250.0):
    rng = np.random.default_rng(seed)
    edges = (span / np.exp2(rng.integers(0, levels, k))).astype(np.float32)
    mins = (rng.random((k, 3)) * span - offset).astype(np.float32)
    num_points = rng.integers(0, 100_000, k).astype(np.int32)
    num_points[::13] = 0  # some empty nodes
    return mins, edges, num_points


def _narrow_frustum():
    """tests/test_culling_pallas.py:29-31: a strict subset is visible."""
    eye = Isometry.from_axis_angle([0, 1, 0], 0.3,
                                   translation=[0.0, 0.0, 300.0])
    return Frustum.new(eye, Perspective.from_fov(1.0, 0.4, 1.0, 400.0))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaN matching NaN."""
    return a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


def _assert_priority_sequence(order_a, order_b, visible, sizes):
    pr = np.where(visible, sizes, -np.inf)
    np.testing.assert_allclose(pr[np.asarray(order_a)],
                               pr[np.asarray(order_b)], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [100, 1000, 2048])
def test_cull_matches_lax_and_pallas(k):
    mins, edges, num_points = _table(k, seed=k)
    frustum = _narrow_frustum()
    axes, qmin, qmax = jax_culling.frustum_axes_and_projections(frustum)
    m = frustum.clip_from_query.astype(np.float32)

    j_order, j_sizes, j_visible = (np.asarray(x) for x in
                                   jax_culling.frustum_cull_lod_select(
        *(jnp.asarray(a) for a in (m, axes, qmin, qmax, mins, edges,
                                   num_points))))
    p_priority, p_visible = (np.asarray(x) for x in
                             frustum_cull_lod_select_pallas(
        m, axes, qmin, qmax, mins, edges, num_points, interpret=True))
    args = _t(m, axes, qmin, qmax, mins, edges, num_points)
    order, sizes, visible = (x.numpy() for x in
                             culling.frustum_cull_lod_select(*args))
    p_sizes, p_vis, priority = (x.numpy() for x in
                                cull_cuda.cull_lod_plain(*args))

    assert 0 < j_visible.sum() < k  # discriminative scene
    assert order.dtype == np.int32 and sizes.dtype == np.float32
    for vis in (visible, p_vis):
        np.testing.assert_array_equal(vis, j_visible)
        np.testing.assert_array_equal(vis, p_visible)
    np.testing.assert_array_equal(sizes, p_sizes)  # one arithmetic
    np.testing.assert_allclose(sizes[j_visible], j_sizes[j_visible],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(priority[j_visible], p_priority[j_visible],
                               rtol=RTOL, atol=ATOL)
    assert np.all(priority[~j_visible] == -np.inf)
    _assert_priority_sequence(order, j_order, j_visible, j_sizes)
    # Visible nodes first, by descending size; ties keep index order.
    n_vis = int(visible.sum())
    assert visible[order[:n_vis]].all() and not visible[order[n_vis:]].any()
    head = priority[order[:n_vis]]
    assert np.all(head[:-1] >= head[1:])


def test_cull_empty_table():
    frustum = _narrow_frustum()
    axes, qmin, qmax = culling.frustum_axes_and_projections(frustum)
    m = frustum.clip_from_query.astype(np.float32)
    empty = (np.zeros((0, 3), np.float32), np.zeros(0, np.float32),
             np.zeros(0, np.int32))
    order, sizes, visible = culling.frustum_cull_lod_select(
        *_t(m, axes, qmin, qmax, *empty))
    assert order.shape == sizes.shape == visible.shape == (0,)
    assert order.dtype == torch.int32 and visible.dtype == torch.bool
    mats = np.stack([m, m])
    fo, fs, fv = culling.frustum_cull_lod_select_frames(
        *_t(mats, np.stack([axes] * 2), np.stack([qmin] * 2),
            np.stack([qmax] * 2), *empty))
    assert fo.shape == fs.shape == fv.shape == (2, 0)


def _orbit(f):
    """The batched orbit of bench.py:628-636."""
    out = []
    for ang in np.linspace(0, 0.2, f):
        e = Isometry.from_axis_angle([0, 1, 0], 0.4 + ang,
                                     translation=[60.0, 45.0, 260.0])
        out.append(Frustum.new(e, Perspective.from_fov(1.5, 1.2, 0.5,
                                                       1000.0)))
    return out


def test_frames_match_jax_frames_and_own_single_frames():
    mins, edges, num_points = _table(1500, seed=3, levels=8, span=200.0,
                                     offset=0.0)
    frustums = _orbit(5)
    prep = jax_culling.prep_frustum_frames(frustums)
    for ours, theirs in zip(culling.prep_frustum_frames(frustums), prep):
        np.testing.assert_array_equal(ours, theirs)  # copied host prep
    table = (mins, edges, num_points)
    j_order, j_sizes, j_visible = (np.asarray(x) for x in
                                   jax_culling.frustum_cull_lod_select_frames(
        *(jnp.asarray(a) for a in (*prep, *table))))
    order, sizes, visible = culling.frustum_cull_lod_select_frames(
        *_t(*prep, *table))
    assert order.shape == (5, 1500)
    np.testing.assert_array_equal(visible.numpy(), j_visible)
    for i in range(5):
        vis = j_visible[i]
        assert 0 < vis.sum() < 1500
        np.testing.assert_allclose(sizes[i].numpy()[vis], j_sizes[i][vis],
                                   rtol=RTOL, atol=ATOL)
        _assert_priority_sequence(order[i], j_order[i], vis, j_sizes[i])
        one = culling.frustum_cull_lod_select(
            *_t(*(p[i] for p in prep), *table))
        for got, want in zip(one, (order[i], sizes[i], visible[i])):
            assert _same(got, want)


def test_host_cull_is_the_jax_host_cull():
    mins, edges, num_points = _table(2048, seed=9, levels=8, span=100.0,
                                     offset=0.0)
    eye = Isometry.from_axis_angle([0, 1, 0], 0.3,
                                   translation=[50.0, 50.0, 180.0])
    frustum = Frustum.new(eye, Perspective.from_fov(1.3, 1.2, 0.5, 500.0))
    args = (frustum.clip_from_query.astype(np.float32),
            *culling.frustum_axes_and_projections(frustum), mins, edges,
            num_points)
    for ours, theirs in zip(culling.frustum_cull_lod_select_host(*args),
                            jax_culling.frustum_cull_lod_select_host(*args)):
        np.testing.assert_array_equal(ours, theirs)


def test_pad_cull_axes_is_inert():
    """Zero axes with a (-inf, inf) range separate nothing: padding to 40
    axes (past the Pallas kernel's 32) leaves every output bit-equal."""
    mins, edges, num_points = _table(700, seed=21)
    frustum = _narrow_frustum()
    axes, qmin, qmax = culling.frustum_axes_and_projections(frustum)
    padded = culling.pad_cull_axes(axes, qmin, qmax, 40)
    for ours, theirs in zip(padded,
                            jax_culling.pad_cull_axes(axes, qmin, qmax, 40)):
        np.testing.assert_array_equal(ours, theirs)
    m = frustum.clip_from_query.astype(np.float32)
    plain = culling.frustum_cull_lod_select(
        *_t(m, axes, qmin, qmax, mins, edges, num_points))
    wide = culling.frustum_cull_lod_select(
        *_t(m, *padded, mins, edges, num_points))
    # Inert axes among the live ones, not only at the tail: zero axes and
    # copies of live axes, both with a (-inf, inf) range (the kernel drops
    # them wherever they stand).
    rng = np.random.default_rng(21)
    inert = np.concatenate([np.zeros((4, 3), np.float32),
                            axes[rng.integers(0, len(axes), 4)]])
    at = np.sort(rng.integers(0, len(axes) + 1, len(inert)))
    mixed = (np.insert(axes, at, inert, axis=0),
             np.insert(qmin, at, -np.inf).astype(np.float32),
             np.insert(qmax, at, np.inf).astype(np.float32))
    assert len(mixed[0]) == len(axes) + 8 and np.isinf(mixed[1]).sum() == 8
    interleaved = culling.frustum_cull_lod_select(
        *_t(m, *mixed, mins, edges, num_points))
    for a, b, c in zip(plain, wide, interleaved):
        assert _same(a, b) and _same(a, c)


# --- a model of csrc/cull.cu's rules ---------------------------------------

_INF = float("inf")


def _model_cull(m, axes, qmin, qmax, mins, edges, num_points,
                fallback=True):
    """K5 as csrc/cull.cu computes it, on CPU tensors, one frame: the
    frame's (-inf, inf) axes dropped; on each axis the projections of the
    two extreme corners (the smaller and the larger term on each
    coordinate, ordered by one `<`, so a NaN term lands in an extreme), and
    all 8 corners with NaN-propagating min and max where an extreme is not
    finite (skipped when `fallback` is False); the screen size from the 18
    distinct products and the 12 distinct (x, y) partial sums.  Returns
    (sizes, visible, priority)."""
    lo = [mins[:, d] + 0.0 * edges for d in range(3)]
    hi = [mins[:, d] + 1.0 * edges for d in range(3)]
    separated = torch.zeros(edges.shape[0], dtype=torch.bool)
    live = ~((qmin == -_INF) & (qmax == _INF))
    for a in torch.nonzero(live).flatten().tolist():
        u = axes[a]
        ends = []
        for d in range(3):
            t0, t1 = lo[d] * u[d], hi[d] * u[d]
            lt = t0 < t1
            ends.append((torch.where(lt, t0, t1), torch.where(lt, t1, t0)))
        p_min = (ends[0][0] + ends[1][0]) + ends[2][0]
        p_max = (ends[0][1] + ends[1][1]) + ends[2][1]
        sep = (p_min > qmax[a]) | (p_max < qmin[a])
        if fallback:
            b_lo = b_hi = None
            for c in range(8):
                x, y, z = (hi[d] if (c >> d) & 1 else lo[d] for d in range(3))
                p = (x * u[0] + y * u[1]) + z * u[2]
                b_lo = p if c == 0 else torch.minimum(b_lo, p)
                b_hi = p if c == 0 else torch.maximum(b_hi, p)
            finite = torch.isfinite(p_min) & torch.isfinite(p_max)
            sep = torch.where(finite, sep, (b_lo > qmax[a]) | (b_hi < qmin[a]))
        separated |= sep

    def row_terms(r):
        px = [lo[0] * m[r, 0], hi[0] * m[r, 0]]
        py = [lo[1] * m[r, 1], hi[1] * m[r, 1]]
        xy = [px[0] + py[0], px[1] + py[0], px[0] + py[1], px[1] + py[1]]
        return xy, [lo[2] * m[r, 2], hi[2] * m[r, 2]]

    terms = {r: row_terms(r) for r in (0, 1, 3)}
    x_lo = x_hi = y_lo = y_hi = None
    for c in range(8):
        clip = {r: (xy[c & 3] + z[c >> 2]) + m[r, 3]
                for r, (xy, z) in terms.items()}
        px = (clip[0] / clip[3]).clamp(-1.0, 1.0)
        py = (clip[1] / clip[3]).clamp(-1.0, 1.0)
        if c == 0:
            x_lo = x_hi = px
            y_lo = y_hi = py
        else:
            x_lo, x_hi = torch.minimum(x_lo, px), torch.maximum(x_hi, px)
            y_lo, y_hi = torch.minimum(y_lo, py), torch.maximum(y_hi, py)
    sizes = (x_hi - x_lo) * (y_hi - y_lo)
    visible = ~separated & (num_points > 0)
    return sizes, visible, torch.where(visible, sizes, -_INF)


def _model_agrees(args, fallback=True) -> bool:
    """The model and cull_lod_plain on one frame: separated (every node
    holds points, so visible = not separated), sizes and priorities bit for
    bit, NaN matching NaN."""
    got = _model_cull(*args, fallback=fallback)
    want = cull_cuda.cull_lod_plain(*args)
    return all(_same(g, w) for g, w in zip(got, want))


# IEEE corner cases: signed zeros, subnormals, magnitudes whose products
# or sums overflow, infinities and NaN.
_SPECIAL = [0.0, -0.0, 1.0, -1.0, 0.5, -2.0, 1e-45, -1e-45, 1e-40, 1.2e-38,
            1e19, 1e38, -1e38, 3e38, -3e38, _INF, -_INF, float("nan")]
_F32 = st.one_of(st.sampled_from(_SPECIAL),
                 st.floats(-1e3, 1e3, width=32),
                 st.floats(width=32, allow_nan=True, allow_infinity=True))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(data=st.data(), k=st.integers(1, 12), a=st.integers(0, 6))
def test_cull_model_matches_plain(data, k, a):
    """Nodes, axes (some inert, anywhere), query ranges and the matrix from
    IEEE corner cases and ordinary values: negative edges, zero axis
    components, overflow, NaN."""
    def floats(*shape):
        n = int(np.prod(shape))
        vals = data.draw(st.lists(_F32, min_size=n, max_size=n))
        return torch.tensor(vals, dtype=torch.float32).reshape(shape)

    axes, qmin, qmax = floats(a, 3), floats(a), floats(a)
    if a:
        inert = torch.tensor(data.draw(st.lists(st.booleans(), min_size=a,
                                                max_size=a)))
        qmin[inert], qmax[inert] = -_INF, _INF
    args = (floats(4, 4), axes, qmin, qmax, floats(k, 3), floats(k),
            torch.ones(k, dtype=torch.int32))
    assert _model_agrees(args)


def test_cull_model_needs_the_fallback():
    """Without the 8-corner fallback the two-corner rule is wrong: x1 = 3e38
    + 3e38 overflows, so on an axis with ux = 0 one corner's term is inf * 0
    = NaN.  The 8-corner min/max is NaN there and separates nothing; the
    other extreme, 0, lies below qmin = 10 and would separate the node."""
    m = torch.eye(4)
    axes = torch.tensor([[0.0, -1.0, 0.0]])
    qmin, qmax = torch.tensor([10.0]), torch.tensor([20.0])
    mins = torch.tensor([[3e38, 0.0, 0.0], [0.0, 0.0, 0.0]])
    edges = torch.tensor([3e38, 1.0])
    args = (m, axes, qmin, qmax, mins, edges, torch.ones(2, dtype=torch.int32))
    assert _model_agrees(args)
    assert not _model_agrees(args, fallback=False)
    assert cull_cuda.cull_lod_plain(*args)[1].tolist() == [True, False]


def test_straddling_nodes_match_jax_nan_and_order():
    """Cubes with a corner at the eye (0/0 = NaN screen size), across the
    camera plane (+-inf, clamped) and behind the camera: the plain version
    propagates NaN and clamps as the lax step does, and a visible NaN
    priority sorts last of all, after the invisible nodes' -inf, as in
    jnp.argsort."""
    frustum = Frustum.new(Isometry.identity(),
                          Perspective.from_fov(1.0, 1.0, 0.1, 100.0))
    m = frustum.clip_from_query.astype(np.float32)
    axes, qmin, qmax = culling.frustum_axes_and_projections(frustum)
    mins = np.array([[0.0, 0.0, -1.0],    # corner at the eye, visible
                     [0.0, 0.0, 0.0],     # corner at the eye, behind
                     [-1.0, -1.0, -1.0],  # w = -z is 0 on a face
                     [-0.5, -0.5, -0.25],  # straddles z = 0
                     [2.0, 2.0, 5.0],     # behind the camera
                     [-1.0, -1.0, -10.0]], dtype=np.float32)
    edges = np.array([1.0, 1.0, 2.0, 0.5, 1.0, 2.0], dtype=np.float32)
    num_points = np.full(6, 7, np.int32)
    order, sizes, visible = culling.frustum_cull_lod_select(
        *_t(m, axes, qmin, qmax, mins, edges, num_points))
    j_order, j_sizes, j_visible = (np.asarray(x) for x in
                                   jax_culling.frustum_cull_lod_select(
        *(jnp.asarray(a) for a in (m, axes, qmin, qmax, mins, edges,
                                   num_points))))
    np.testing.assert_array_equal(visible.numpy(), j_visible)
    np.testing.assert_allclose(sizes.numpy(), j_sizes, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(order.numpy(), j_order)
    assert np.isnan(j_sizes[:2]).all() and j_visible[0] and not j_visible[1]
    assert order[-1] == 0


def test_cull_lod_rejects_bad_shapes():
    m = torch.eye(4)
    axes, q = torch.zeros(5, 3), torch.zeros(5)
    mins, edges, n = torch.zeros(3, 3), torch.ones(3), torch.ones(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="num_points"):
        cull_cuda.cull_lod(m, axes, q, q, mins, edges, n.to(torch.int64))
    with pytest.raises(ValueError, match="qmin"):
        cull_cuda.cull_lod(m, axes, q[:4], q, mins, edges, n)
    with pytest.raises(ValueError, match="matrix"):
        cull_cuda.cull_lod(m[None], axes, q, q, mins, edges, n)


def _session_scene():
    """tests/test_device_ops.py:220-235."""
    rng = np.random.default_rng(9)
    k = 2048
    levels = rng.integers(0, 8, k)
    edges = (100.0 / np.exp2(levels)).astype(np.float32)
    mins = (rng.random((k, 3)) * 100.0).astype(np.float32)
    num_points = rng.integers(0, 1000, k).astype(np.int32)
    frustums = [
        Frustum.new(
            Isometry.from_axis_angle(
                [0, 1, 0], 0.2 + 0.1 * i, translation=[50.0, 50.0, 180.0]
            ),
            Perspective.from_fov(1.2, 1.0, 0.5, 400.0),
        )
        for i in range(4)
    ]
    return mins, edges, num_points, frustums


@pytest.mark.parametrize("table_dtype", [np.float32, np.float64])
def test_session_matches_jax_session(table_dtype):
    mins, edges, num_points, frustums = _session_scene()
    mins, edges = mins.astype(table_dtype), edges.astype(table_dtype)
    ours = culling.DeviceCullSession(mins, edges, num_points,
                                     axis_capacity=8, device="cpu")
    theirs = jax_culling.DeviceCullSession(mins, edges, num_points,
                                           axis_capacity=8)
    singles = []
    for f in frustums:
        o, s, v = ours.step(f)
        jo, js, jv = theirs.step(f)
        assert o.dtype == np.int32 and s.dtype == np.float32
        assert v.dtype == bool and 0 < v.sum() < len(v)
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_allclose(s[v], js[v], rtol=RTOL, atol=ATOL)
        _assert_priority_sequence(o, jo, jv, js)
        assert ours.a_cap == theirs.a_cap
        singles.append((o, s, v))
    assert ours.a_cap > 8  # grew past the deliberately tiny capacity

    fo, fs, fv = ours.step_frames(frustums)
    jo, js, jv = theirs.step_frames(frustums)
    assert fo.shape == (4, 2048) and ours.a_cap == theirs.a_cap
    np.testing.assert_array_equal(fv, jv)
    for i, (o, s, v) in enumerate(singles):
        np.testing.assert_allclose(fs[i][fv[i]], js[i][jv[i]], rtol=RTOL,
                                   atol=ATOL)
        _assert_priority_sequence(fo[i], jo[i], jv[i], js[i])
        np.testing.assert_array_equal(fo[i], o)  # own single frame: exact
        np.testing.assert_array_equal(fs[i], s)
        np.testing.assert_array_equal(fv[i], v)


def test_session_step_frames_grows_and_handles_no_frames():
    mins, edges, num_points, frustums = _session_scene()
    ours = culling.DeviceCullSession(mins, edges, num_points,
                                     axis_capacity=4, device="cpu")
    theirs = jax_culling.DeviceCullSession(mins, edges, num_points,
                                           axis_capacity=4)
    for got, want in zip(ours.step_frames([]), theirs.step_frames([])):
        assert got.shape == want.shape == (0, 2048)
        assert got.dtype == want.dtype
    ours.step_frames(frustums[:2])
    theirs.step_frames(frustums[:2])
    assert ours.a_cap == theirs.a_cap > 4


# --- the host prep's dedup_axes, held byte for byte to the JAX loop ---------

_UNIT = jax_sat.UNIT_AXES


def _viewer_orbit(frames=60):
    """A turn of the viewer's camera round a box: 800 x 600 at 45 degrees,
    yawed about z and pitched by 60 degrees."""
    pitch = Isometry.from_axis_angle([1, 0, 0], np.pi / 3)
    out = []
    for a in np.linspace(0.0, 2 * np.pi, frames, endpoint=False):
        eye = Isometry.from_axis_angle(
            [0, 0, 1], a + np.pi / 2,
            translation=[120 * np.cos(a), 120 * np.sin(a), 60.0]).compose(pitch)
        out.append(Frustum.new(eye, Perspective.from_fov(
            800 / 600, np.pi / 4, 0.1, 10000.0)))
    return out


def _near(delta):
    """An axis, and the same axis moved by delta along x, with either sign:
    squared distances delta**2 (d1) and, for the flipped copy, d2."""
    a = np.array([0.0, 0.0, 1.0])
    b = a + [delta, 0.0, 0.0]
    return np.stack([a, b, -a, -b])


def _dedup_case(case):
    """(candidate sets, rows the JAX loop keeps of each, or None).  The
    default eps is 2**-52, so d = 2**-26 is a distance at eps."""
    d = 2.0 ** -26
    if case == "orbit":
        return [f.intersector().separating_axes_with(_UNIT, _UNIT)
                for f in _viewer_orbit()], None
    if case == "axis_aligned_frustum":
        eye = Isometry.from_axis_angle([0, 1, 0], 0.0, translation=[1, 2, 30])
        f = Frustum.new(eye, Perspective.from_fov(1.3, 0.8, 0.5, 100.0))
        return [f.intersector().separating_axes_with(_UNIT, _UNIT)], None
    if case == "obb":
        return [Obb(Isometry.from_axis_angle(axis, angle), [1.0, 2.0, 3.0])
                .intersector().separating_axes_with(_UNIT, _UNIT)
                for axis, angle in (([0, 0, 1], 0.0), ([0, 0, 1], np.pi / 4),
                                    ([1, 2, 3], 0.7))], None
    if case == "eps_under":  # delta**2 < eps: one kept of the four
        return [_near(np.nextafter(d, 0.0))], [0]
    if case == "eps_equal":  # delta**2 == eps is not under it
        return [_near(d)], [0, 1]
    if case == "eps_over":
        return [_near(np.nextafter(d, 1.0))], [0, 1]
    if case == "sum_order":  # |v|^2 < eps summed x, y, z in turn, not else
        v = np.array([float.fromhex(h) for h in (
            "0x1.fffffffffffffp-27", "0x1.fb6cd2320df73p-54",
            "0x1.80d29ae5ea3bdp-53")])
        return [np.stack([v, 2 * v])], [0]
    if case == "chain":  # b near a and c, c not near a: a and c kept
        return [np.array([[0.0, 0.0, 1.0], [0.8 * d, 0.0, 1.0],
                          [1.6 * d, 0.0, 1.0]])], [0, 2]
    if case == "single":
        return [np.array([[0.6, 0.0, 0.8]])], [0]
    if case == "empty":
        return [np.empty((0, 3))], []
    assert case == "inf"  # d1 = inf - inf squared = NaN, d2 = inf
    return [np.array([[_INF, 0.0, 0.0], [_INF, 0.0, 0.0], [-_INF, 0.0, 0.0],
                      [_INF, 0.0, 1.0], [0.0, 0.0, 1.0]])], None


@pytest.mark.parametrize("case", [
    "orbit", "axis_aligned_frustum", "obb", "eps_under", "eps_equal",
    "eps_over", "sum_order", "chain", "single", "empty", "inf"])
def test_dedup_axes_is_the_jax_loop(case):
    sets, kept = _dedup_case(case)
    dropped = False
    for axes in sets:
        with np.errstate(invalid="ignore"):
            got = port_sat.dedup_axes(axes)
            want = jax_sat.dedup_axes(axes)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
        if kept is not None:
            assert want.tobytes() == axes[kept].reshape(-1, 3).tobytes()
        dropped |= len(want) < len(axes)
    # Only a lone axis, none, and axes no finite distance joins keep all.
    assert dropped == (case not in ("single", "empty", "inf"))


def test_session_uploads_the_table_to_its_device(monkeypatch):
    mins, edges, num_points, _ = _session_scene()
    session = culling.DeviceCullSession(mins.astype(np.float64), edges,
                                        num_points, device="cpu")
    assert session._mins.dtype == torch.float32
    assert session._num_points.dtype == torch.int32
    assert session._mins.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        culling.DeviceCullSession(mins, edges, num_points)


def test_cpu_cull_counts_no_launch():
    mins, edges, num_points, frustums = _session_scene()
    before = cull_cuda.cull_lod.launches
    session = culling.DeviceCullSession(mins, edges, num_points,
                                        device="cpu")
    session.step(frustums[0])
    session.step_frames(frustums)
    assert cull_cuda.cull_lod.launches == before
