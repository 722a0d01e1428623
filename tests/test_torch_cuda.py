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
