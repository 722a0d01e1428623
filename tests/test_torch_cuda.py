"""Card-only tests of the PyTorch port: each CUDA kernel against its plain
PyTorch version, and the device core, the build and the cull session on
the card against the same code on the CPU.  Integer state: tolerance 0;
the cull's f32 outputs: bit for bit too (NaN matching NaN), since K5 and
its plain version round every operation alike.

Every test here is marked `cuda` and skips where torch sees no card.  This
file imports neither jax, nor the JAX package, nor tests/conftest.py, so it
also runs on a GPU machine without jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
from point_cloud_viewer_tpu_torch.octree.builder import build_octree
from point_cloud_viewer_tpu_torch.ops import cull_cuda as CC
from point_cloud_viewer_tpu_torch.ops import hbm_probe as K7
from point_cloud_viewer_tpu_torch.ops import leaf_levels_cuda as K6
from point_cloud_viewer_tpu_torch.ops import culling
from point_cloud_viewer_tpu_torch.ops import level_cuda as LC
from point_cloud_viewer_tpu_torch.ops import morton
from point_cloud_viewer_tpu_torch.ops import scan_cuda as SC
from point_cloud_viewer_tpu_torch.ops import tree_build as tb
from point_cloud_viewer_tpu_torch.testing import (
    adversarial_node_table,
    device_ops,
)

pytestmark = pytest.mark.cuda

# The build path's kernels (K6: the leaf stage; K4: the promotion stage),
# and K2, K3 and the one-level K4, whose per-level loops the stages
# replaced there.
_WRAPPERS = (SC.scan_1d, LC.promote_stage, K6.leaf_stage)
_OFF_PATH = (LC.seg_start_pass, LC.leaf_update_pass, LC.promote_pass)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _sorted_bounds(n, seed, device):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**63, n, dtype=np.uint64)
    codes[: n // 5] = codes[0]
    codes[n // 5: n // 4] = np.uint64(2**63 - 1)
    sorted_codes = torch.sort(torch.from_numpy(codes.view(np.int64))).values
    return tb._bound_levels(sorted_codes.to(device), 21)


_TILE = 8192  # csrc/lookback_scan.cuh kLbTile (K1 and K2)
_TILE_SIZES = [1, 3, _TILE - 1, _TILE, _TILE + 1, 2 * _TILE + 5, 1_000_003]


def _on_both_streams(fn):
    """fn() twice in a row on the current stream, then on a second stream
    (each call clears its own scratch; stale tile states would show)."""
    first, again = fn(), fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    return first, again, other


@pytest.mark.parametrize("n", _TILE_SIZES)
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_scan_kernel_matches_plain(cuda, n, offset):
    """All six modes bit for bit; offsets 1-3 make the base unaligned for
    16-B loads, so the kernel takes its scalar variant."""
    rng = np.random.default_rng(n + offset)
    x = torch.from_numpy(rng.integers(-1000, 1000, n + offset)
                         .astype(np.int32)).to(cuda)[offset:]
    before = SC.scan_1d.launches
    for kind in ("max", "min", "sum"):
        for reverse in (False, True):
            want = SC.scan_1d_plain(x, kind, reverse)
            for got in _on_both_streams(lambda: SC.scan_1d(x, kind, reverse)):
                assert torch.equal(got, want), (kind, reverse)
    assert SC.scan_1d.launches == before + 18


@pytest.mark.parametrize("n", [1, 4095, 4097, 1_000_003])
def test_level_kernels_match_plain(cuda, n):
    b = _sorted_bounds(n, n, cuda)
    assert torch.equal(b.cpu(), _sorted_bounds(n, n, "cpu"))
    leaf = torch.full((n,), 21, dtype=torch.uint8, device=cuda)
    found = torch.zeros(n, dtype=torch.uint8, device=cuda)
    for level in range(1, 22):
        ss = LC.seg_start_pass(b, level)
        ss_p = LC.seg_start_pass_plain(b, level)
        assert torch.equal(ss, ss_p)
        lk, fk = LC.leaf_update_pass(b, ss, leaf.clone(), found.clone(),
                                     level, 100)
        LC.leaf_update_pass_plain(b, ss_p, leaf, found, level, 100)
        assert torch.equal(lk, leaf) and torch.equal(fk, found)
    cur = leaf.clone()
    for level in range(21, 0, -1):
        ck = LC.promote_pass(b, cur.clone(), level)
        LC.promote_pass_plain(b, cur, level)
        assert torch.equal(ck, cur)


@pytest.mark.parametrize("n", _TILE_SIZES)
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("start_only", [False, True])
def test_seg_start_kernel_offsets_and_start_only(cuda, n, offset,
                                                 start_only):
    """K2 at every level bit for bit, on views at element offsets 0-3 (1-3:
    unaligned bases) and on an input whose only start is element 0, so the
    look-back crosses every tile; twice in a row and on a second stream."""
    if start_only:
        b = torch.full((n + offset,), 22, dtype=torch.uint8)
        b[offset] = 0
    else:
        b = _sorted_bounds(n + offset, n, "cpu")
    b = b.to(cuda)[offset:]
    before = LC.seg_start_pass.launches
    for level in range(1, 22):
        want = LC.seg_start_pass_plain(b, level)
        for got in _on_both_streams(lambda: LC.seg_start_pass(b, level)):
            assert torch.equal(got, want), level
    assert LC.seg_start_pass.launches == before + 63


def _at_offset(t, offset):
    """A copy of t as a view `offset` elements into a fresh buffer (for
    offsets 1-3 its base is not 16-B aligned)."""
    buf = torch.empty(t.shape[0] + offset, dtype=t.dtype, device=t.device)
    buf[offset:].copy_(t)
    return buf[offset:]


def _leaf_update_input(n, kind, device):
    """(b, threshold): boundary levels of sorted codes; or the start-only
    input (element 0 the only start, so every tile's look-back runs to the
    sweep's first tile); or starts at elements 0 and n - 1 only, where every
    row below n - 1 must carry n - 1 as its segment end across the tiles
    (threshold n - 1 makes a lost carry, n, show; 1 when n = 1)."""
    if kind == "codes":
        return _sorted_bounds(n, n, device), 100
    b = torch.full((n,), 22, dtype=torch.uint8, device=device)
    b[:1].fill_(0)
    if kind == "start only":
        return b, n
    b[n - 1:].fill_(0)
    return b, max(n - 1, 1)


@pytest.mark.parametrize("n", _TILE_SIZES)
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", ["codes", "start only", "first and last"])
def test_leaf_update_kernel_offsets_and_start_only(cuda, n, offset, kind):
    """K3 at every level bit for bit (leaf and found, updated in place), all
    four arrays at element offsets 0-3 (1-3: unaligned bases, the scalar
    epilogue), on sorted codes, the start-only input and a start at each
    end; twice in a row and on a second stream, each from fresh state."""
    b, threshold = _leaf_update_input(n, kind, cuda)
    bb = _at_offset(b, offset)
    leaf = torch.full((n,), 21, dtype=torch.uint8, device=cuda)
    found = torch.zeros(n, dtype=torch.uint8, device=cuda)
    before = LC.leaf_update_pass.launches
    for level in range(1, 22):
        ss = _at_offset(LC.seg_start_pass_plain(b, level), offset)

        def call():
            lk, fk = _at_offset(leaf, offset), _at_offset(found, offset)
            out = LC.leaf_update_pass(bb, ss, lk, fk, level, threshold)
            assert out[0] is lk and out[1] is fk
            return lk.clone(), fk.clone()

        runs = _on_both_streams(call)
        LC.leaf_update_pass_plain(b, ss, leaf, found, level, threshold)
        for lk, fk in runs:
            assert torch.equal(lk, leaf) and torch.equal(fk, found), level
    assert LC.leaf_update_pass.launches == before + 63
    if kind != "codes":  # every row is small at its threshold
        assert bool(found.all())


def test_leaf_update_is_one_memset_and_one_launch(cuda):
    """K3 on the look-back: one memset of its scratch and one kernel a call
    (the three-launch sweep it replaced is gone)."""
    b = _sorted_bounds(1_000_003, 5, cuda)
    ss = LC.seg_start_pass(b, 8)
    leaf = torch.full_like(b, 21)
    found = torch.zeros_like(b)
    before = LC.leaf_update_pass.launches
    ops = device_ops(lambda: LC.leaf_update_pass(b, ss, leaf, found, 8, 100),
                     tries=5)
    assert LC.leaf_update_pass.launches == before + 1 + 5
    assert ops == {"kernels": ["lookback_scan"], "memsets": 1}, ops


_PROMOTE_TILE = 8192  # csrc/promote.cu: kPromoteThreads x 32 rows


def _promote_inputs(n, kind, device):
    """(b, leaf) u8: from sorted codes with 37 pad rows (the core's leaf
    stage), or a start-only input whose every row rests at level 21 (the
    longest look-back at every level)."""
    if kind == "start only":
        b = torch.full((n,), 22, dtype=torch.uint8, device=device)
        b[:1].fill_(0)
        return b, torch.full((n,), 21, dtype=torch.uint8, device=device)
    codes = _k6_codes(n, n).to(device)
    return K6.leaf_stage(codes, 21, 21, 100, 0, max(n - 37, 0))


@pytest.mark.parametrize("n", [_PROMOTE_TILE - 1, _PROMOTE_TILE,
                               _PROMOTE_TILE + 1, 2 * _PROMOTE_TILE + 5,
                               1_000_003])
@pytest.mark.parametrize("kind", ["codes", "start only"])
def test_promote_stage_matches_plain(cuda, n, kind):
    """K4 over every level in one launch against its plain version and the
    per-level K4 loop, bit for bit, with stop_level 0 and > 0; twice in a
    row and on a second stream, so stale tile states would show."""
    from point_cloud_viewer_tpu_torch.ops import _ext

    assert _ext.lib().pcv_promote_tile_rows() == _PROMOTE_TILE
    b, leaf = _promote_inputs(n, kind, cuda)
    for stop in (0, 3):
        want = LC.promote_stage_plain(b.cpu(), leaf.cpu(), 21, stop)
        before = (LC.promote_stage.launches, LC.promote_pass.launches)
        for got in _on_both_streams(
                lambda: LC.promote_stage(b, leaf, 21, stop)):
            assert torch.equal(got.cpu(), want), (kind, stop)
        assert (LC.promote_stage.launches,
                LC.promote_pass.launches) == (before[0] + 3, before[1])
        loop = LC.promote_stage_loop(b, leaf, 21, stop)
        assert torch.equal(loop.cpu(), want), (kind, stop)
        assert LC.promote_pass.launches == before[1] + 21 - stop
    assert torch.equal(LC.promote_stage(b, leaf, 5, 5), leaf)


@pytest.mark.parametrize("n", [1, 3, _PROMOTE_TILE + 1, 1_000_003])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_promote_pass_offsets_every_level(cuda, n, offset):
    """The public K4 (one level, in place) at every level on views at
    element offsets 0-3 (1-3: unaligned bases, the kernel's scalar
    loads), from the leaf levels of sorted codes."""
    b0, leaf = _promote_inputs(n + offset, "codes", "cpu")
    b = b0.to(cuda)[offset:]
    buf = leaf.to(cuda)
    cur = buf[offset:]
    want = leaf[offset:].clone()
    before = LC.promote_pass.launches
    for level in range(21, 0, -1):
        LC.promote_pass(b, cur, level)
        LC.promote_pass_plain(b0[offset:], want, level)
        assert torch.equal(cur.cpu(), want), level
    assert torch.equal(buf[:offset].cpu(), leaf[:offset])
    assert LC.promote_pass.launches == before + 21


def test_grouped_core_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(9)
    cells = rng.integers(0, 2**21, (500_000, 3)).astype(np.uint32)
    cells[::5] = cells[0]
    codes = morton.morton_encode(cells)
    for n_real in (len(codes), len(codes) - 1000):
        on_cpu = tb.build_tree_device_codes_grouped(
            morton.codes_to_tensor(codes, "cpu"), n_real, 21, 21, 1000,
            extras_cap=4096)
        on_card = tb.build_tree_device_codes_grouped(
            morton.codes_to_tensor(codes, cuda), n_real, 21, 21, 1000,
            extras_cap=4096)
        for name, c, g in zip(tb.GroupedExchange._fields, on_cpu, on_card):
            assert torch.equal(c, g.cpu()), name


def test_build_on_card_matches_cpu(cuda, tmp_path):
    rng = np.random.default_rng(7)
    n = 150_000
    batch = PointsBatch(
        position=np.concatenate([rng.random((n, 3)) * 12.0,
                                 6.0 + rng.normal(0, 0.01, (n, 3))]),
        attributes={"intensity": rng.random(2 * n).astype(np.float32)},
    )
    before = [w.launches for w in _WRAPPERS + _OFF_PATH]
    card, cpu = tmp_path / "card", tmp_path / "cpu"
    build_octree(str(card), 0.001, batch, use_device=True, device=cuda)
    after = [w.launches for w in _WRAPPERS + _OFF_PATH]
    build_octree(str(cpu), 0.001, batch, use_device=True, device="cpu")
    k = len(_WRAPPERS)
    assert all(a > b for a, b in zip(after[:k], before[:k]))
    assert after[k:] == before[k:]
    names = sorted(p.name for p in cpu.iterdir())
    assert names == sorted(p.name for p in card.iterdir())
    for name in names:
        assert (card / name).read_bytes() == (cpu / name).read_bytes(), name


def _same(a, b):
    """Bit for bit, NaN matching NaN (-0 matches +0)."""
    a, b = a.cpu(), b.cpu()
    return a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


def _cull_frames(frames, a_cap):
    """`frames` frusta orbiting a 100 m box, axes padded to a_cap."""
    frustums = [
        culling.Frustum.new(
            culling.Isometry.from_axis_angle(
                [0, 1, 0], 0.2 + 0.15 * i, translation=[50.0, 50.0, 180.0]),
            culling.Perspective.from_fov(1.2, 1.0, 0.5, 400.0))
        for i in range(frames)
    ]
    return frustums, culling.prep_frustum_frames(frustums, a_cap)


def _cull_table(k, seed):
    """Random cubes, some empty, some across the eyes' camera planes."""
    rng = np.random.default_rng(seed)
    edges = (100.0 / np.exp2(rng.integers(0, 9, k))).astype(np.float32)
    mins = (rng.random((k, 3)) * [100.0, 100.0, 200.0]).astype(np.float32)
    num_points = rng.integers(0, 1000, k).astype(np.int32)
    num_points[::11] = 0
    return mins, edges, num_points


@pytest.mark.parametrize("k,frames,a_cap", [
    (0, 1, 32), (1, 1, 32), (4097, 1, 32), (4097, 1, 40), (20_000, 3, 64),
])
def test_cull_kernel_matches_plain(cuda, k, frames, a_cap):
    mins, edges, num_points = _cull_table(k, seed=k + a_cap)
    _, (mats, axs, qns, qxs) = _cull_frames(frames, a_cap)
    table = [torch.from_numpy(a).to(cuda) for a in (mins, edges, num_points)]
    batched = [torch.from_numpy(a).to(cuda) for a in (mats, axs, qns, qxs)]
    before = CC.cull_lod.launches
    got = CC.cull_lod(*batched, *table)
    want = CC.cull_lod_plain(*batched, *table)
    assert CC.cull_lod.launches == before + (1 if k else 0)
    for g, w in zip(got, want):
        assert g.shape == (frames, k) and _same(g, w)
    for f in range(frames):
        one = CC.cull_lod(*(t[f] for t in batched), *table)
        for g, w in zip(one, got):
            assert _same(g, w[f])
    if k > 1000:  # a strict subset of the nodes is visible
        assert 0 < int(got[1].sum()) < frames * k


_INF = float("inf")


def _cull_setup(kind, frames, a_cap):
    """(F, ...) per-frame arrays: the orbit, an every-node-visible view of
    the 100 m box, or frames whose axes are all inert ((-inf, inf))."""
    if kind == "all visible":
        frustums = [culling.Frustum.new(
            culling.Isometry.from_axis_angle(
                [0, 1, 0], 0.01 * i, translation=[50.0, 50.0, 700.0]),
            culling.Perspective.from_fov(1.2, 1.0, 1.0, 10000.0))
            for i in range(frames)]
        return culling.prep_frustum_frames(frustums, a_cap)
    mats, axs, qns, qxs = _cull_frames(frames, a_cap)[1]
    if kind == "inert only":
        qns[:], qxs[:] = -_INF, _INF
    return mats, axs, qns, qxs


@pytest.mark.parametrize("table", ["random", "adversarial"])
@pytest.mark.parametrize("kind", ["orbit", "all visible", "inert only"])
@pytest.mark.parametrize("frames", [1, 3])
def test_cull_kernel_adversarial_and_inert_frames(cuda, table, kind, frames):
    """K5 bit for bit (NaN matching NaN) on a table of IEEE corner cases and
    on an ordinary one, for an orbit frame, an all-visible frame and a frame
    whose axes are all inert; one frame as (4, 4) and F frames at once."""
    make = adversarial_node_table if table == "adversarial" else _cull_table
    mins, edges, num_points = make(20_000, seed=frames)
    per_frame = [torch.from_numpy(a).to(cuda)
                 for a in _cull_setup(kind, frames, 32)]
    if frames == 1:
        per_frame = [t[0] for t in per_frame]
    nodes = [torch.from_numpy(a).to(cuda) for a in (mins, edges, num_points)]
    before = CC.cull_lod.launches
    got = CC.cull_lod(*per_frame, *nodes)
    want = CC.cull_lod_plain(*per_frame, *nodes)
    assert CC.cull_lod.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == want[0].shape and _same(g, w)
    has_points = nodes[2] > 0
    if kind == "inert only" or (kind == "all visible" and table == "random"):
        assert torch.equal(got[1], has_points.expand_as(got[1]))
    if table == "adversarial":
        assert bool(got[0].isnan().any())


def test_cull_kernel_nan_and_straddle_match_plain(cuda):
    """An eye at the origin: cubes with a corner at the eye (w = 0 and
    q = 0: NaN sizes), across the camera plane (+-inf, clamped) and
    behind it."""
    frustum = culling.Frustum.new(
        culling.Isometry.identity(),
        culling.Perspective.from_fov(1.0, 1.0, 0.1, 100.0))
    axes, qmin, qmax = culling.frustum_axes_and_projections(frustum)
    rng = np.random.default_rng(3)
    mins = np.concatenate([
        np.array([[0.0, 0.0, -1.0], [0.0, 0.0, 0.0], [-1.0, -1.0, -1.0],
                  [-0.5, -0.5, -0.25], [2.0, 2.0, 5.0]]),
        rng.integers(-8, 8, (3000, 3)) * 0.5,
    ]).astype(np.float32)
    edges = np.concatenate([[1.0, 1.0, 2.0, 0.5, 1.0],
                            rng.choice([0.5, 1.0, 2.0], 3000)])
    args = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
            for a in (frustum.clip_from_query, axes, qmin, qmax, mins,
                      edges)]
    args.append(torch.full((len(edges),), 3, dtype=torch.int32))
    args = [t.to(cuda) for t in args]
    got = CC.cull_lod(*args)
    want = CC.cull_lod_plain(*args)
    for g, w in zip(got, want):
        assert _same(g, w)
    assert bool(got[0].isnan().any()) and bool(got[1][0])
    order, _, _ = culling.frustum_cull_lod_select(*args)
    assert torch.equal(order.cpu(), culling.frustum_cull_lod_select(
        *(t.cpu() for t in args))[0])


def test_cull_session_on_card_matches_cpu(cuda):
    mins, edges, num_points = _cull_table(50_000, seed=5)
    frustums, _ = _cull_frames(6, 0)
    card = culling.DeviceCullSession(mins, edges, num_points,
                                     axis_capacity=8, device=cuda)
    cpu = culling.DeviceCullSession(mins, edges, num_points,
                                    axis_capacity=8, device="cpu")
    before = CC.cull_lod.launches
    for f in frustums:
        for a, b in zip(card.step(f), cpu.step(f)):
            assert _same(torch.from_numpy(a), torch.from_numpy(b))
    for a, b in zip(card.step_frames(frustums), cpu.step_frames(frustums)):
        assert _same(torch.from_numpy(a), torch.from_numpy(b))
    assert CC.cull_lod.launches == before + len(frustums) + 1
    assert card.a_cap == cpu.a_cap > 8


# --- K5 on the viewers' paths ------------------------------------------------


@pytest.fixture
def viewer_tree(tmp_path):
    rng = np.random.default_rng(14)
    n = 60_000
    out = str(tmp_path / "tree")
    build_octree(out, 0.01, PointsBatch(
        position=rng.random((n, 3)) * np.array([30.0, 30.0, 10.0]),
        attributes={"color": rng.integers(0, 256, (n, 3), dtype=np.uint8)}),
        device="cpu")
    return out


def test_windowed_shell_over_stub_launches_k5_on_card(cuda, viewer_tree):
    """run_windowed through SdlBackend over the port's libSDL2 stub, its
    cull on the card (the default): keys w, left, CTRL+SHIFT+1 (save pose
    slot 0) and CTRL+1 (load it), a present a frame, pixels uploaded, the
    pose saved, K5 launched."""
    import os
    import ctypes

    from point_cloud_viewer_tpu_torch import native
    from point_cloud_viewer_tpu_torch.viewer.sdl_shell import (
        SdlBackend, run_windowed)

    path = native.sdl2_stub_path()
    stub = ctypes.CDLL(path)
    stub.pcv_stub_get.argtypes = [ctypes.c_char_p]
    stub.pcv_stub_pixel_sum.restype = ctypes.c_uint64
    stub.pcv_stub_reset()
    for scancode, mod in ((26, 0), (80, 0), (30, 0x0041), (30, 0x0040)):
        stub.pcv_stub_push_keydown(scancode, mod)
        stub.pcv_stub_push_frame_end()
    before = CC.cull_lod.launches
    run_windowed(viewer_tree, backend=SdlBackend(160, 120, lib_path=path),
                 width=160, height=120, cache_size_mb=10, max_frames=6)
    assert stub.pcv_stub_get(b"render_present") == 6
    assert stub.pcv_stub_pixel_sum() > 0
    assert os.path.exists(os.path.join(viewer_tree, "poses.json"))
    assert CC.cull_lod.launches > before


def test_gl_viewer_culls_on_card(cuda, viewer_tree):
    """GlPointCloudRenderer with its cull on the card (the default) draws
    the visible set the CPU route selects, and launches K5."""
    import time

    from point_cloud_viewer_tpu_torch.octree.octree import Octree
    from point_cloud_viewer_tpu_torch.viewer import gl
    from point_cloud_viewer_tpu_torch.viewer.camera import Camera

    if not gl.available():
        pytest.skip("no EGL/GL driver on this machine")
    from point_cloud_viewer_tpu_torch.viewer.gl.viewer import (
        GlPointCloudRenderer)

    octree = Octree.from_directory(viewer_tree)
    camera = Camera(320, 240)
    camera.position = octree.bounding_box.center() + np.array(
        [20.0, -30.0, 15.0])
    camera.theta, camera.phi = 0.6, np.pi / 3
    matrix = camera.world_to_gl()
    before = CC.cull_lod.launches
    drawn = []
    for device in (cuda, "cpu"):
        r = GlPointCloudRenderer(octree, width=320, height=240, device=device)
        try:
            r.camera_changed(matrix)
            deadline = time.perf_counter() + 60
            while True:
                stats, image = r.draw(matrix, render=True)
                if stats.visible_nodes and (
                        stats.nodes_drawn == stats.visible_nodes):
                    break
                assert time.perf_counter() < deadline
                time.sleep(0.02)
            with r._visible_lock:
                drawn.append([n.value for n in r._visible])
        finally:
            r.shutdown()
    assert drawn[0] == drawn[1]
    assert CC.cull_lod.launches > before
    assert np.any(image != image[0, 0], axis=-1).sum() > 500


# --- K6 and the sync-free derivation ---------------------------------------


def _k6_codes(n, seed, kind="mixed"):
    rng = np.random.default_rng(seed)
    if kind == "dups":  # one run of a single code
        codes = np.full(n, rng.integers(0, 2**63, dtype=np.uint64))
    else:
        codes = rng.integers(0, 2**63, n, dtype=np.uint64)
        codes[: n // 3] = codes[0] & ~np.uint64(2**30 - 1) | rng.integers(
            0, 2**30, n // 3, dtype=np.uint64)
        codes[n // 3: n // 3 + n // 10] = np.uint64(2**63 - 1)
    return torch.sort(torch.from_numpy(codes.view(np.int64))).values


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 8191, 8193, 1_000_003])
def test_leaf_levels_kernel_matches_plain(cuda, n):
    codes = _k6_codes(n, n).to(cuda)
    before = K6.leaf_levels.launches
    stage_before = K6.leaf_stage.launches
    for t in (1, 100, 5_000):
        got = K6.leaf_levels(codes, 21, 21, t)
        assert torch.equal(got, K6.leaf_levels_plain(codes, 21, 21, t))
        core = tb.build_tree_device_codes_grouped(codes, n, 21, 21, t)
        assert torch.equal(got, core.leaf.to(torch.int32))
    # Each entry counts its own launches: three public K6 calls, and one
    # leaf stage in each of the three derivations.
    assert K6.leaf_levels.launches == before + 3
    assert K6.leaf_stage.launches == stage_before + 3


@pytest.mark.parametrize("n,t", [(5000, 0), (5000, 4999), (5000, 5000),
                                 (9000, 2**40)])
def test_leaf_levels_kernel_one_run_and_threshold_extremes(cuda, n, t):
    for kind in ("dups", "mixed"):
        codes = _k6_codes(n, 7, kind).to(cuda)
        for depth, max_split in ((21, 21), (9, 13), (21, 5)):
            got = K6.leaf_levels(codes, depth, max_split, t)
            want = K6.leaf_levels_plain(codes, depth, max_split, t)
            assert torch.equal(got, want), (kind, depth, max_split)


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 8191, 8192, 8193,
                               1_000_003])
@pytest.mark.parametrize("root", [0, 2])
def test_leaf_stage_matches_loop(cuda, n, root):
    """The core's leaf stage (one K6 run) against `_bound_levels` + the
    K2 + K3 loop on the card and on the CPU, (b, leaf) bit for bit: pad
    rows (n_real < n), the start rule past `depth`, and a code view whose
    base is not 16-B aligned (the kernel's scalar loads)."""
    host = _k6_codes(n + 1, n + root)
    for depth, max_split in ((21, 21), (9, 13), (21, 5)):
        for n_real in sorted({n, max(n - 37, 0), n - 1}):
            # Sorted real rows, then pad rows of arbitrary codes.
            codes = host[1:].clone()
            codes[n_real:] = host[1:][n_real:].flip(0)
            for label, on_card in (("aligned", codes.to(cuda)),
                                   ("offset 1", host.to(cuda)[1:])):
                if label == "offset 1":
                    on_card.copy_(codes)
                before = K6.leaf_stage.launches
                got = K6.leaf_stage(on_card, depth, max_split, 100, root,
                                    n_real)
                assert K6.leaf_stage.launches == before + 1
                loop = K6.leaf_stage_loop(on_card, depth, max_split, 100,
                                          root, n_real)
                plain = K6.leaf_stage(codes, depth, max_split, 100, root,
                                      n_real)
                for g, w, p, name in zip(got, loop, plain, ("b", "leaf")):
                    assert g.dtype == torch.uint8, name
                    assert torch.equal(g, w), (label, depth, max_split,
                                               n_real, name)
                    assert torch.equal(g.cpu(), p), (label, name)


def test_leaf_stage_threshold_extremes_and_empty(cuda):
    for kind in ("dups", "mixed"):
        codes = _k6_codes(9000, 3, kind).to(cuda)
        for t in (0, 1, 8999, 9000, 2**40):
            for depth, max_split in ((21, 21), (9, 13), (21, 5)):
                got = K6.leaf_stage(codes, depth, max_split, t)
                want = K6.leaf_stage_plain(codes.cpu(), depth, max_split, t)
                assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    empty = torch.zeros(0, dtype=torch.int64, device=cuda)
    before = K6.leaf_stage.launches
    b, leaf = K6.leaf_stage(empty, 21, 21, 100)
    assert b.shape == leaf.shape == (0,) and K6.leaf_stage.launches == before


def test_derivation_makes_no_host_sync(cuda):
    """Between upload and fetch the derivation never waits on the card."""
    rng = np.random.default_rng(11)
    cells = rng.integers(0, 2**21, (300_000, 3)).astype(np.uint32)
    cells[::4] = cells[1]
    codes = morton.morton_encode(cells)
    on_card = morton.codes_to_tensor(codes, cuda)
    # Warm up: the kernel library, the allocators and the sort.
    tb.fetch_grouped(tb.tree_codes_grouped_on_device(codes, 21, 21,
                                                     device=cuda))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tb.build_tree_device_codes_grouped(on_card, len(codes) - 7, 21,
                                                 21, 1000, extras_cap=4096)
        out2 = tb.tree_codes_grouped_on_device(codes, 21, 21, root_level=1,
                                               stop_level=1, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = tb.build_tree_device_codes_grouped(
        morton.codes_to_tensor(codes, "cpu"), len(codes) - 7, 21, 21, 1000,
        extras_cap=4096)
    for name, g, w in zip(tb.GroupedExchange._fields, out, want):
        assert torch.equal(g.cpu(), w), name
    want2 = tb.tree_codes_grouped_on_device(codes, 21, 21, root_level=1,
                                            stop_level=1, device="cpu")
    for name, g, w in zip(tb.GroupedExchange._fields, out2, want2):
        assert torch.equal(g.cpu(), w), name


def _streaming_batch(seed):
    """Two level-1 buckets past the node threshold, each a dense blob that
    splits to the depth cap beside four lone points (1-point leaves, so
    extras), a sparse octant that needs no subtree, and an anchor."""
    rng = np.random.default_rng(seed)
    lone = np.array([[15.0, 2, 2], [2, 15, 2], [2, 2, 15], [12, 12, 3]])
    parts = []
    for corner in (np.zeros(3), np.array([20.0, 0, 0])):
        parts += [corner + 3.0 + rng.random((100_003, 3)) * 1e-3,
                  corner + lone]
    parts += [rng.random((5_000, 3)) * 20.0 + [0.0, 20.0, 0.0],
              np.array([[40.0, 40.0, 40.0]])]
    position = np.concatenate(parts)
    return PointsBatch(position=position, attributes={
        "color": rng.integers(0, 256, (len(position), 3), dtype=np.uint8)})


@pytest.mark.parametrize("extras_cap", [None, 1])
def test_streaming_build_on_card_matches_cpu(cuda, tmp_path, monkeypatch,
                                             extras_cap):
    from point_cloud_viewer_tpu_torch.octree.streaming import (
        build_octree_streaming,
    )

    if extras_cap is not None:
        orig = tb.tree_codes_grouped_on_device

        def capped(*args, **kwargs):
            kwargs["extras_cap"] = extras_cap
            return orig(*args, **kwargs)

        monkeypatch.setattr(tb, "tree_codes_grouped_on_device", capped)
    batch = _streaming_batch(seed=3)
    before = [w.launches for w in _WRAPPERS + _OFF_PATH]
    phases = {}
    card, cpu = tmp_path / "card", tmp_path / "cpu"
    build_octree_streaming(str(card), 0.001, batch, bucket_levels=1,
                           device=cuda, phase_times=phases)
    after = [w.launches for w in _WRAPPERS + _OFF_PATH]
    build_octree_streaming(str(cpu), 0.001, batch, bucket_levels=1,
                           device="cpu")
    k = len(_WRAPPERS)
    assert all(a > b for a, b in zip(after[:k], before[:k]))
    assert after[k:] == before[k:]
    up, down = phases["bucket_upload_bytes"], phases["bucket_fetch_bytes"]
    # 8 B/pt up; down ~4 B/pt, or 6 B/pt on the classic route (overflow).
    assert (down > 0.75 * up) == (extras_cap == 1)
    names = sorted(p.name for p in cpu.iterdir())
    assert names == sorted(p.name for p in card.iterdir())
    for name in names:
        assert (card / name).read_bytes() == (cpu / name).read_bytes(), name


def test_streaming_builds_reuse_the_pipeline_stream_and_its_memory(
        cuda, tmp_path):
    """Back-to-back streamed builds derive on one stream, so once a build
    has run the caching allocator serves the next from its freed blocks:
    no new device segment (cudaMalloc) in a later build."""
    from point_cloud_viewer_tpu_torch.octree import streaming

    batch = _streaming_batch(seed=4)

    def build(i):
        streaming.build_octree_streaming(str(tmp_path / f"b{i}"), 0.001,
                                         batch, bucket_levels=1, device=cuda)
        torch.cuda.synchronize()
        return torch.cuda.memory_stats()["segment.all.allocated"]

    build(0)
    made = build(1)
    assert build(2) == made
    here = torch.device("cuda", torch.cuda.current_device())
    assert streaming._pipeline_stream(cuda) is streaming._pipeline_stream(here)


# --- deep builds: re-rooted sub-builds at depth 12-19 ---------------------


def _deep_codes(n, depth, seed):
    """Sorted int64 codes of a re-rooted sub-build at `depth`: half in a
    dense corner (a deep run of splits), runs of one code, the rest spread
    over the cell's whole 3 * depth-bit code space."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2 ** (3 * depth), n, dtype=np.uint64)
    codes[: n // 2] >>= np.uint64(3 * (depth // 2))
    codes[n // 2: n // 2 + n // 8] = codes[n // 2]
    codes[-(n // 16):] = np.uint64(2 ** (3 * depth) - 1)
    return torch.sort(torch.from_numpy(codes.view(np.int64))).values


@pytest.mark.parametrize("n", [1, 8191, 8193, 1_000_003])
@pytest.mark.parametrize("depth", [12, 19])
def test_stages_at_sub_build_depths_match_plain(cuda, depth, n):
    """The K6 leaf stage and the K4 promotion stage as a deep sub-build runs
    them (depth = max split level = 12 or 19, root 0), with and without 37
    pad rows of arbitrary codes, against their plain versions bit for
    bit, and the grouped derivation around them against its CPU route."""
    host = _deep_codes(n, depth, seed=n + depth)
    for n_real in sorted({n, max(n - 37, 0)}):
        codes = host.clone()
        codes[n_real:] = host[n_real:].flip(0)
        on_card = codes.to(cuda)
        before = (K6.leaf_stage.launches, LC.promote_stage.launches)
        b, leaf = K6.leaf_stage(on_card, depth, depth, 100, 0, n_real)
        want_b, want_leaf = K6.leaf_stage_plain(codes, depth, depth, 100, 0,
                                                n_real)
        assert torch.equal(b.cpu(), want_b), (depth, n_real, "b")
        assert torch.equal(leaf.cpu(), want_leaf), (depth, n_real, "leaf")
        cur = LC.promote_stage(b, leaf, depth, 0)
        want = LC.promote_stage_plain(want_b, want_leaf, depth, 0)
        assert torch.equal(cur.cpu(), want), (depth, n_real, "final")
        assert (K6.leaf_stage.launches,
                LC.promote_stage.launches) == (before[0] + 1, before[1] + 1)
        got = tb.build_tree_device_codes_grouped(on_card, n_real, depth,
                                                 depth, 100, extras_cap=64)
        ref = tb.build_tree_device_codes_grouped(codes, n_real, depth, depth,
                                                 100, extras_cap=64)
        for name, g, w in zip(tb.GroupedExchange._fields, got, ref):
            assert torch.equal(g.cpu(), w), (depth, n_real, name)


def test_argsort_codes_on_device_card_matches_cpu(cuda):
    rng = np.random.default_rng(4)
    for n in (1, 5, 1_000_003):
        codes = rng.integers(0, 2**63, n, dtype=np.uint64)
        codes[: n // 3] = codes[0]
        codes[-(n // 4):] = np.uint64(2**63 - 1)
        got_codes, got_order = tb.argsort_codes_on_device(codes, cuda)
        want_codes, want_order = tb.argsort_codes_on_device(codes, "cpu")
        assert got_order.dtype == np.int64
        np.testing.assert_array_equal(got_order, want_order)
        np.testing.assert_array_equal(got_codes, want_codes)


def test_deep_build_on_card_matches_host_route(cuda, tmp_path, monkeypatch):
    """A planet-box cloud with two fat level-21 cells, the device threshold
    lowered to 1,000: in core and streamed on the card, byte-equal to the
    host route; the K6 and K4 stages and K1 launched once a device
    sub-build, K2, K3 and the one-level K4 never."""
    from point_cloud_viewer_tpu_torch.math.geometry import Aabb
    from point_cloud_viewer_tpu_torch.octree import builder as B
    from point_cloud_viewer_tpu_torch.octree.streaming import (
        build_octree_streaming,
    )

    monkeypatch.setattr(B, "_DEEP_DEVICE_MIN_N", 1_000)
    edge21 = 6.4e6 / (1 << 21)
    rng = np.random.default_rng(19)
    position = np.concatenate([
        (0.5 + rng.normal(0.0, 0.05, (150_000, 3))) * edge21,
        1e6 + rng.random((120_000, 3)) * edge21 * 0.9,
        rng.random((20_000, 3)) * 6.4e6])
    batch = PointsBatch(position=position, attributes={
        "color": rng.integers(0, 256, (len(position), 3), dtype=np.uint8)})
    box = Aabb(np.zeros(3), np.full(3, 6.4e6))
    host = tmp_path / "host"
    build_octree(str(host), 0.001, batch, bounding_box=box, use_device=False)
    names = sorted(p.name for p in host.iterdir())
    assert any(len(name) > len("r.xyz") + 21 for name in names)
    for streamed in (False, True):
        out = tmp_path / f"card{int(streamed)}"
        for w in _WRAPPERS + _OFF_PATH:
            w.launches = 0
        phases = {}
        if streamed:
            build_octree_streaming(str(out), 0.001, batch, bounding_box=box,
                                   device=cuda, phase_times=phases)
        else:
            build_octree(str(out), 0.001, batch, bounding_box=box,
                         device=cuda, phase_times=phases)
        assert phases["deep_device_subbuilds"] == 2, phases
        assert [w.launches for w in _WRAPPERS] == [2, 2, 2], streamed
        assert [w.launches for w in _OFF_PATH] == [0, 0, 0], streamed
        assert sorted(p.name for p in out.iterdir()) == names
        for name in names:
            assert (out / name).read_bytes() == (host / name).read_bytes(), (
                streamed, name)


# --- K7, the streaming-bandwidth probe ----------------------------------------


@pytest.mark.parametrize("n", [1, 3, 5, 4097, 1_000_003])
@pytest.mark.parametrize("offset", [0, 1])
def test_stream_probe_kernel_matches_plain(cuda, n, offset):
    """Every mode bit for bit at ragged n; offset 1 makes the inputs
    unaligned for float4, so the kernel takes its scalar loop."""
    rng = np.random.default_rng(n + offset)
    x, y, z = (torch.from_numpy(rng.standard_normal(n + offset)
                                .astype(np.float32)).to(cuda)[offset:]
               for _ in range(3))
    s = torch.tensor([rng.standard_normal()], dtype=torch.float32,
                     device=cuda)
    before = K7.stream_probe.launches
    for mode, extra in (("copy", ()), ("triad", (y,)), ("add3", (y, z))):
        got = K7.stream_probe(mode, x, s, *extra)
        want = K7.stream_probe_plain(mode, x, s, *extra)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), mode
    assert K7.stream_probe.launches == before + 3


def test_hbm_probes_on_card(cuda):
    out = K7.hbm_probes(cuda, n=4_000_000, iters=3,
                        generator=torch.Generator(cuda).manual_seed(0))
    shapes = ("add_1d", "add_2d", "copy", "triad", "add3")
    rates = [out[f"hbm_probe_{k}_gbps"] for k in shapes]
    assert all(r > 0 for r in rates) and out["hbm_probe_gbps"] == max(rates)
    assert torch.cuda.get_device_name(cuda).split()[-1] in out["card"]


# --- the query filter --------------------------------------------------------


def _query_geometries():
    from point_cloud_viewer_tpu_torch.math.geometry import (
        Frustum, Isometry, Obb, Perspective)

    obb = Obb(Isometry.from_axis_angle([1, 1, 0], 0.7,
                                       translation=[1.0, -2.0, 3.0]),
              np.array([6.0, 4.0, 9.0]))
    eye = Isometry.from_axis_angle([0, 1, 0], 0.4,
                                   translation=[0.0, 0.0, 30.0])
    return obb, Frustum.new(eye, Perspective.from_fov(1.1, 0.9, 1.0, 60.0))


@pytest.mark.parametrize("kind", ["obb", "frustum"])
def test_face_point_masks_on_card_match_cpu_and_host(cuda, kind):
    """1,048,576 points on the faces: the card's mask (K8, band refined on
    the host) equals the CPU route's and the host's."""
    from point_cloud_viewer_tpu_torch import testing
    from point_cloud_viewer_tpu_torch.query import device_filter as DF
    from point_cloud_viewer_tpu_torch.query.location import location_for

    obb, frustum = _query_geometries()
    g = obb if kind == "obb" else frustum
    make = (testing.obb_face_points if kind == "obb"
            else testing.frustum_plane_points)
    pts = make(g, 1 << 20, seed=21)
    loc = location_for(g)
    host = loc.contains(pts)
    stats = DF.FilterStats()
    card = DF.point_filter_mask(loc, pts, device=cuda, stats=stats)
    np.testing.assert_array_equal(card, host)
    np.testing.assert_array_equal(
        DF.point_filter_mask(loc, pts, device="cpu"), host)
    assert 0 < stats.uncertain < len(pts)


def test_s2_ids_and_masks_on_card_match_cpu_and_host(cuda):
    """Leaf ids on all six faces with argmax ties and bit 63 set, a cell
    union with bit-63 ranges and a WebMercatorRect: card, CPU route and
    host bit for bit; the card's WebMercator margin is calibrated on it."""
    from point_cloud_viewer_tpu_torch import testing
    from point_cloud_viewer_tpu_torch.math import s2, s2_device
    from point_cloud_viewer_tpu_torch.math.web_mercator import (
        WebMercatorCoord, WebMercatorRect, ecef_to_web_mercator)
    from point_cloud_viewer_tpu_torch.math.web_mercator_device import (
        _calibrated_delta)
    from point_cloud_viewer_tpu_torch.query import device_filter as DF
    from point_cloud_viewer_tpu_torch.query.location import location_for
    from point_cloud_viewer_tpu_torch.s2_cells.cell_union import CellUnion

    pts = testing.s2_face_points(1 << 20, seed=22)
    host = s2.leaf_cell_ids_from_points(pts)
    for dev in (cuda, torch.device("cpu")):
        got = s2_device.leaf_ids(torch.from_numpy(pts).to(dev))
        np.testing.assert_array_equal(got.cpu().numpy().view(np.uint64), host)
    union = CellUnion([int(c) for c in s2.parent(host[::5000], 9)])
    assert (union._range_min >= np.uint64(1 << 63)).any()
    uv = ecef_to_web_mercator(pts[:2])
    rect = WebMercatorRect(WebMercatorCoord(uv.min(axis=0) - 0.05),
                           WebMercatorCoord(uv.min(axis=0) + 0.05))
    for loc in (union, location_for(rect)):
        want = loc.contains(pts)
        for dev in (cuda, "cpu"):
            np.testing.assert_array_equal(
                DF.point_filter_mask(loc, pts, device=dev), want)
    assert 1e-9 <= _calibrated_delta(cuda) < 1e-6


# --- K8: the query mask's kernel ---------------------------------------------


def _fused_only(monkeypatch):
    """Make the eager route raise: every call below must take K8."""
    from point_cloud_viewer_tpu_torch.query import device_filter as DF

    def eager(*args, **kwargs):
        raise AssertionError("the eager route ran where K8 should")

    monkeypatch.setattr(DF, "_eager_classes", eager)
    return DF


@pytest.mark.parametrize("with_intervals", [False, True])
@pytest.mark.parametrize("n", [0, 1, 65_535, 65_536, 65_537, 100_000])
@pytest.mark.parametrize("kind", ["box", "obb", "frustum", "web_mercator"])
def test_k8_mask_matches_host(cuda, monkeypatch, kind, n, with_intervals):
    """K8's mask, band refined on the host, bit-equal to the host's
    contains() and interval filters, near and on the region's faces."""
    from point_cloud_viewer_tpu_torch import testing

    DF = _fused_only(monkeypatch)
    loc, pts, intervals, attrs = testing.query_mask_case(
        kind, n, seed=n + 7, with_intervals=with_intervals)
    stats = DF.FilterStats()
    got = DF.point_filter_mask(loc, pts, intervals, attrs, device=cuda,
                               stats=stats)
    want = testing.query_mask_host(loc, pts, intervals, attrs)
    assert got.dtype == np.bool_ and got.shape == (n,)
    np.testing.assert_array_equal(got, want)
    assert stats.rows == n
    if n >= 65_535 and kind != "box":
        assert 0 < stats.uncertain < n


@pytest.mark.parametrize("with_intervals", [False, True])
@pytest.mark.parametrize("kind", ["obb", "frustum"])
def test_k8_face_points_match_host(cuda, monkeypatch, kind, with_intervals):
    """The 1,048,576 face points of the eager route's card test, through
    K8, with and without intervals."""
    from point_cloud_viewer_tpu_torch import testing
    from point_cloud_viewer_tpu_torch.query.location import location_for

    DF = _fused_only(monkeypatch)
    obb, frustum = _query_geometries()
    g = obb if kind == "obb" else frustum
    make = (testing.obb_face_points if kind == "obb"
            else testing.frustum_plane_points)
    pts = make(g, 1 << 20, seed=21)
    _, _, intervals, attrs = testing.query_mask_case(
        "box", 1 << 20, seed=21, with_intervals=with_intervals)
    loc = location_for(g)
    stats = DF.FilterStats()
    got = DF.point_filter_mask(loc, pts, intervals, attrs, device=cuda,
                               stats=stats)
    np.testing.assert_array_equal(
        got, testing.query_mask_host(loc, pts, intervals, attrs))
    assert 0 < stats.uncertain < len(pts)


def test_k8_web_mercator_boundary_band(cuda, monkeypatch):
    """Points on the rect's edges and 1e-12 either side of them."""
    from point_cloud_viewer_tpu_torch import testing
    from point_cloud_viewer_tpu_torch.math import wgs84
    from point_cloud_viewer_tpu_torch.math.web_mercator import (
        web_mercator_to_lat_lng)
    from point_cloud_viewer_tpu_torch.query.location import location_for

    DF = _fused_only(monkeypatch)
    rect = testing.query_mask_region("web_mercator")
    nw, se = rect.north_west.normalized, rect.south_east.normalized
    rng = np.random.default_rng(17)
    us = np.concatenate([np.repeat([nw[0], se[0]], 40),
                         rng.uniform(nw[0], se[0], 80)])
    vs = np.concatenate([rng.uniform(nw[1], se[1], 80),
                         np.repeat([nw[1], se[1]], 40)])
    for nudge in (0.0, 1e-12, -1e-12):
        lat, lon = web_mercator_to_lat_lng(np.stack([us + nudge, vs], -1))
        pts = wgs84.geodetic_to_ecef(lat, lon, 0.0)
        np.testing.assert_array_equal(
            DF.point_filter_mask(location_for(rect), pts, device=cuda),
            rect.contains(pts))


@pytest.mark.parametrize("kind", ["box", "obb", "frustum", "web_mercator"])
def test_k8_non_finite_rows_match_host(cuda, monkeypatch, kind):
    """NaN and infinite coordinates: K8 puts them in the band or decides
    them as the host does."""
    from point_cloud_viewer_tpu_torch import testing

    DF = _fused_only(monkeypatch)
    loc, pts, intervals, attrs = testing.query_mask_case(
        kind, 2_000, seed=5, with_intervals=True)
    pts[::7, 1] = np.nan
    pts[3::11, 0] = np.inf
    pts[5::13, 2] = -np.inf
    with np.errstate(invalid="ignore"):
        got = DF.point_filter_mask(loc, pts, intervals, attrs, device=cuda)
        want = testing.query_mask_host(loc, pts, intervals, attrs)
    np.testing.assert_array_equal(got, want)


def test_k8_calibrated_delta(cuda):
    """The margin measured on K8's own projection."""
    from point_cloud_viewer_tpu_torch.math.web_mercator_device import (
        _calibrated_delta)

    delta = _calibrated_delta(cuda, fused=True)
    assert np.isfinite(delta) and 1e-9 <= delta < 1e-6


def test_k8_seven_threads_match_one(cuda, monkeypatch):
    """Seven threads masking different nodes at once, as the client's
    workers do, get one thread's answers."""
    import threading

    from point_cloud_viewer_tpu_torch import testing

    DF = _fused_only(monkeypatch)
    cases = [testing.query_mask_case(kind, 30_000 + 1_000 * i, seed=i,
                                     with_intervals=i % 2 == 1)
             for i, kind in enumerate(testing.QUERY_MASK_KINDS * 4)]
    want = [DF.point_filter_mask(*c, device=cuda) for c in cases]
    got = [[] for _ in range(7)]
    errors = []

    def work(t):
        try:
            for rep in range(3):
                for i in range(t, len(cases) + t):
                    j = i % len(cases)
                    got[t].append((j, DF.point_filter_mask(*cases[j],
                                                           device=cuda)))
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(7)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for per_thread in got:
        assert len(per_thread) == 3 * len(cases)
        for j, mask in per_thread:
            np.testing.assert_array_equal(mask, want[j])


# --- K8 on the client's nodes as stored ---------------------------------------


@pytest.fixture(scope="module")
def decode_octrees(tmp_path_factory):
    """testing.query_decode_octree in each stored encoding."""
    from point_cloud_viewer_tpu_torch import testing

    return {enc: testing.query_decode_octree(
        str(tmp_path_factory.mktemp(f"octree_{enc}")), enc)
        for enc in testing.QUERY_DECODE_RESOLUTIONS}


def _decode_query(octree, kind, k, attributes=None):
    from point_cloud_viewer_tpu_torch import testing
    from point_cloud_viewer_tpu_torch.query.point_query import PointQuery

    return PointQuery(
        attributes=attributes or ["color", "intensity",
                                  *testing.QUERY_DECODE_COLUMNS],
        location=testing.query_decode_regions(octree)[kind],
        filter_intervals=testing.query_decode_intervals(k))


def _host_node(octree, query, node_id, device=None):
    """A node by today's route: read_node_batch, then the host's masks (or
    K8's f64 entry on `device`) and retain."""
    batch = octree.points_in_node(node_id, attributes=query.attributes)
    return query.filter_batch(batch, use_device=device is not None,
                              device=device)


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
    query.decode.card and query.decode.host)."""
    from torch.profiler import ProfilerActivity, profile

    from point_cloud_viewer_tpu_torch.utils import progress

    progress.reset_span_totals()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    totals = progress.span_totals()
    progress.reset_span_totals()
    return out, tuple(totals.get(name, [0])[0] for name in (
        "query.decode.card", "query.decode.host"))


@pytest.mark.parametrize("k", [0, 1, 8])
@pytest.mark.parametrize("kind", ["box", "obb", "frustum", "web_mercator"])
@pytest.mark.parametrize("encoding", ["u8", "u16", "f32", "f64"])
def test_k8_node_decode_matches_host(cuda, monkeypatch, decode_octrees,
                                     encoding, kind, k):
    """Every node decoded, classified and compacted on the card: the host's
    read_node_batch, masks and retain to the bit (positions, every
    attribute, row order), and K8's f64 entry on the host's decode too; u8
    and u16 nodes on both sides of the native decode's 10,000 rows; the
    band of each kind refined (OBB and frustum on the host's decode)."""
    from point_cloud_viewer_tpu_torch.query.device_filter import (
        _host_decode_fused, node_decode)

    DF = _fused_only(monkeypatch)
    octree = decode_octrees[encoding]
    query = _decode_query(octree, kind, k)
    route = node_decode(query, [octree], cuda)
    stats = DF.FilterStats()

    def run():
        return [route.node_points(octree, node_id, stats=stats)
                for node_id in octree.node_ids]

    got, (card, host) = _decode_counters(run)
    sizes = set()
    for node_id, batch in zip(octree.node_ids, got):
        meta = octree.node_meta(node_id)
        sizes.add(meta.num_points >= 10_000)
        _assert_batches_equal(batch, _host_node(octree, query, node_id))
        _assert_batches_equal(batch, _host_node(octree, query, node_id, cuda))
    assert sizes == {False, True}
    assert card + host == len(octree.node_ids)
    if kind != "box":
        assert stats.uncertain > 0
    if kind in ("obb", "frustum"):
        assert host > 0
    else:
        assert host == 0
    if encoding in ("u8", "u16"):
        print(encoding, "native decode contracted:",
              _host_decode_fused(octree.node_meta(octree.node_ids[0])
                                 .position_encoding, 10_000))


def test_k8_node_decode_keeps_no_row_and_every_row(cuda, decode_octrees):
    """A box away from the site keeps no row of the root, a box around the
    site every row."""
    from point_cloud_viewer_tpu_torch.math.geometry import Aabb
    from point_cloud_viewer_tpu_torch.octree.node_id import NodeId
    from point_cloud_viewer_tpu_torch.query.device_filter import node_decode
    from point_cloud_viewer_tpu_torch.query.location import location_for

    for encoding in ("u8", "f32"):
        octree = decode_octrees[encoding]
        lo, hi = octree.root_cube.min, octree.root_cube.max()
        for box, kept in ((Aabb(hi + 1.0, hi + 2.0), 0),
                          (Aabb(lo - 1.0, hi + 1.0), 10_004)):
            query = _decode_query(octree, "box", 1)
            query.location = location_for(box)
            query.filter_intervals = {}
            got = node_decode(query, [octree], cuda).node_points(
                octree, NodeId.root())
            assert len(got) == kept
            _assert_batches_equal(got, _host_node(octree, query,
                                                  NodeId.root()))


@pytest.mark.parametrize("n", [1, 1_023, 1_024, 1_025, 99_999, 1_000_003])
@pytest.mark.parametrize("encoding", ["u16", "f32"])
def test_k8_node_decode_compacts_in_row_order(cuda, tmp_path, encoding, n):
    """Synthetic nodes of up to ~1,000 look-back tiles: the kept rows in
    row order, against the host's decode and masks, twice on the same
    staging set (the kernel leaves its scratch zero)."""
    from point_cloud_viewer_tpu_torch import testing
    from point_cloud_viewer_tpu_torch.query import device_filter as DF

    node, query = testing.query_decode_node(str(tmp_path), encoding, n,
                                            seed=n, share=0.6)
    route = DF.NodeDecode(query, [], cuda)
    want = testing.query_decode_node_host(node, query)
    assert 0 < len(want) < n or n == 1
    for _ in range(2):
        _assert_batches_equal(route.node_points(node, "r"), want)


def test_k8_node_decode_seven_threads_match_host(cuda, decode_octrees):
    """The client on the card with seven workers, over each region and
    encoding: the host route's points."""
    from point_cloud_viewer_tpu_torch import testing
    from point_cloud_viewer_tpu_torch.query.client import PointCloudClient

    def collect(client, query):
        got = list(client.stream(query))
        pos = np.concatenate([b.position for b in got])
        col = np.concatenate([b.attributes["color"] for b in got])
        val = np.concatenate([b.attributes["intensity"] for b in got])
        # Rows that decode to one position (u8 nodes) sorted by colour and
        # intensity too: the workers' order is not fixed.
        order = np.lexsort((val, *col.T[::-1], *pos.T[::-1]))
        return pos[order], col[order], val[order]

    for encoding, octree in decode_octrees.items():
        for kind in testing.QUERY_MASK_KINDS:
            query = _decode_query(octree, kind, 1,
                                  attributes=["color", "intensity"])
            want = collect(PointCloudClient([octree], num_threads=7,
                                            device_filter=False), query)
            client = PointCloudClient([octree], num_threads=7, device=cuda)
            (got, (card, host)) = _decode_counters(
                lambda: collect(client, query))
            assert card > 0
            for g, w in zip(got, want):
                assert g.tobytes() == w.tobytes(), (encoding, kind)


# --- the x-ray splat (torch ops on the card, no kernel of the port) ---------


@pytest.mark.parametrize("n,size", [(0, 256), (1, 8), (1_000_003, 256),
                                    (300_000, 1448)])
def test_xray_reductions_on_card_match_cpu(cuda, n, size):
    """The four reductions on the card against their CPU route, every output
    bit for bit, with heights and intensities on a 1/64 step (the
    exactness condition: f64 sums exact in any order); image_size 1448 is
    the packed keyspace's largest, 1449 is refused on both."""
    from point_cloud_viewer_tpu_torch import testing
    from point_cloud_viewer_tpu_torch.xray import device_splat as DS

    inputs = testing.xray_splat_inputs(n, size, seed=n + size)
    got = testing.xray_splat_outputs(inputs, size, cuda)
    want = testing.xray_splat_outputs(inputs, size, "cpu")
    assert testing.xray_splat_differences(got, want) == []
    for dev in (cuda, "cpu"):
        with pytest.raises(ValueError, match="1448"):
            DS.xray_occupancy_device(np.array([7]), 1449, dev)


_XRAY_FAMILIES = [
    ("xray", {}),
    ("colored", {}),
    ("colored_with_intensity", {"min_intensity": 0.1, "max_intensity": 100.0}),
    ("colored_with_height_stddev", {"max_stddev": 2.0}),
    ("colored", {"binning": ("ts", 10.0)}),
    ("colored_with_intensity", {"min_intensity": 0.1, "max_intensity": 100.0,
                                "binning": ("ts", 10.0)}),
]


@pytest.mark.parametrize("family", _XRAY_FAMILIES,
                         ids=lambda f: f[0] + ("_binned" if f[1] else ""))
@pytest.mark.parametrize("size", [64, 256])
def test_xray_strategies_on_card_match_numpy_route(cuda, family, size):
    """Each strategy family renders on the card the numpy route's tile byte
    for byte under the exactness condition; with heights off any step the
    height stddev differs by at most 1 per channel."""
    from point_cloud_viewer_tpu_torch import testing

    kind, kwargs = family
    batches = [testing.xray_points(60_000, seed) for seed in (1, 2)]
    card = testing.xray_render(kind, kwargs, batches, size, cuda)
    want = testing.xray_render(kind, kwargs, batches, size, None)
    assert testing.image_difference(card, want) == (0, 0)
    assert card.tobytes() == want.tobytes()
    if kind == "colored_with_height_stddev":
        batches = [testing.xray_points(60_000, seed, step=None)
                   for seed in (3, 4)]
        pixels, most = testing.image_difference(
            testing.xray_render(kind, kwargs, batches, size, cuda),
            testing.xray_render(kind, kwargs, batches, size, None))
        print(f"full-f64 heights at {size} px: {pixels} pixels differ, by "
              f"at most {most}")
        assert most <= 1


def test_build_tree_device_on_card_matches_cpu(cuda):
    """The full device core from cells (K6 and K4 on the card, once each)
    against its CPU route, every output bit for bit."""
    rng = np.random.default_rng(12)
    cells = rng.integers(0, 2**21, (700_003, 3)).astype(np.uint32)
    cells[: 200_000] = (cells[: 200_000] >> 9) + 1_000_000
    cells[-1] = 2**21 - 1
    before = (K6.leaf_stage.launches, LC.promote_stage.launches)
    got = tb.build_tree_device(morton.cells_to_tensor(cells, cuda), 21, 21,
                               5_000)
    torch.cuda.synchronize()
    assert (K6.leaf_stage.launches - before[0],
            LC.promote_stage.launches - before[1]) == (1, 1)
    want = tb.build_tree_device(morton.cells_to_tensor(cells, "cpu"), 21, 21,
                                5_000)
    for name, g, w in zip(tb.DeviceTreeResult._fields, got, want):
        assert torch.equal(g.cpu(), w), name
    assert len(torch.unique(want.final_level)) >= 3


def test_sharded_tree_levels_on_two_card_shards_match_cpu_mesh(cuda):
    """Two shards sharing the card against a two-shard CPU mesh, shard by
    shard; K6 and K4 launched once a shard."""
    from point_cloud_viewer_tpu_torch.parallel.mesh import make_mesh
    from point_cloud_viewer_tpu_torch.parallel.sharded_build import (
        sharded_morton_sort,
        sharded_tree_levels,
    )

    rng = np.random.default_rng(13)
    cells = rng.integers(0, 2**21, (400_001, 3)).astype(np.uint32)
    cells[: 150_000] = (cells[: 150_000] >> 10) + 700_000
    codes = morton.morton_encode(cells)
    card = make_mesh(devices=[cuda, cuda])
    cpu = make_mesh(2, device="cpu")
    before = (K6.leaf_stage.launches, LC.promote_stage.launches)
    got = sharded_tree_levels(codes, card, 21, 2, 21, 5_000)
    assert (K6.leaf_stage.launches - before[0],
            LC.promote_stage.launches - before[1]) == (2, 2)
    want = sharded_tree_levels(codes, cpu, 21, 2, 21, 5_000)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)
    stats, cpu_stats = {}, {}
    for a, b in zip(sharded_morton_sort(cells, card, 21, 1.0, stats=stats),
                    sharded_morton_sort(cells, cpu, 21, 1.0,
                                        stats=cpu_stats)):
        np.testing.assert_array_equal(a, b)
    assert stats == cpu_stats
