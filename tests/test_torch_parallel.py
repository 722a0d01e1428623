"""The port's multi-device pieces (point_cloud_viewer_tpu_torch/parallel/,
ops/morton.morton_encode_device, ops/sort.py, ops/tree_build.
build_tree_device) on CPU meshes against the JAX package on its virtual
CPU devices (tests.conftest.cpu_mesh).

Every output is held bit for bit, except the f32 stats step's positions:
its JAX sort is unstable over 2 keys, so positions are compared after
ordering each run of equal codes.  build_tree_device's t_norm is held bit
for bit to the exact power-of-two formula; the JAX value equals it where
XLA:CPU's `jnp.exp2` returns the exact power of two, which it does not
for odd exponents from 13 up (exp2(21) = 2097153: a fault of the JAX
package, ROADMAP queue 3), so past depth 12 the two are compared within
that error.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from point_cloud_viewer_tpu.ops import morton as jax_morton
from point_cloud_viewer_tpu.ops import sort as jax_sort
from point_cloud_viewer_tpu.ops.tree_build import (
    build_tree_device as jax_build_tree_device,
)
from point_cloud_viewer_tpu.parallel import sharded_build as JS
from point_cloud_viewer_tpu_torch.ops import _ext, morton, sort
from point_cloud_viewer_tpu_torch.ops.tree_build import (
    build_tree_device,
    build_tree_device_codes,
)
from point_cloud_viewer_tpu_torch.parallel import sharded_build as TS
from point_cloud_viewer_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate,
    shard,
)
from tests.conftest import cpu_mesh

MESHES = [1, 2, 3, 5, 8]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tests run beside other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _cells(n, depth, seed):
    """Uniform cells, a dense knot, duplicates, and both corner cells."""
    rng = np.random.default_rng(seed)
    top = 1 << depth
    cells = rng.integers(0, top, (n, 3)).astype(np.uint32)
    knot = rng.normal(top / 3, max(top / 200, 0.5), (n // 3, 3))
    cells[: n // 3] = np.clip(knot, 0, top - 1).astype(np.uint32)
    cells[::7] = cells[1]
    cells[0] = 0
    cells[-1] = top - 1
    return cells


def _skewed_cells():
    """__graft_entry__.py:145-150: 40% of 64,000 points in one knot."""
    rng = np.random.default_rng(11)
    pos = rng.random((64_000, 3)) * 100.0
    pos[:25_600] *= 0.01
    pos = pos[rng.permutation(64_000)]
    return jax_morton.quantize(pos, np.zeros(3), 100.0, jax_morton.MAX_DEPTH)


# --- Morton encode and the device sort -------------------------------------


@pytest.mark.parametrize("depth", [1, 7, 11, 16, 21])
def test_morton_encode_device_matches_jax(depth):
    cells = _cells(5_000, depth, seed=depth)
    # Bits past `depth` are ignored, as the JAX loop ignores them.
    cells[3] = 0xFFFFFFFF
    cells[4] = [1 << depth, 0x80000000, 12345]
    hi, lo = jax_morton.morton_encode_device(jnp.asarray(cells), depth)
    want = jax_morton.join_u64(np.asarray(hi), np.asarray(lo))
    got = morton.morton_encode_device(morton.cells_to_tensor(cells, "cpu"),
                                      depth)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(_u64(got), want)
    if depth == 21:
        np.testing.assert_array_equal(_u64(got)[5:],
                                      jax_morton.morton_encode(cells[5:]))
        assert _u64(got)[-1] == 2**63 - 1
    # int64 cells encode the same.
    np.testing.assert_array_equal(
        _u64(morton.morton_encode_device(
            torch.from_numpy(cells.astype(np.int64)), depth)), want)


def test_morton_encode_device_rejects_bad_input():
    with pytest.raises(ValueError):
        morton.morton_encode_device(torch.zeros(4, 2, dtype=torch.int32))
    with pytest.raises(ValueError):
        morton.morton_encode_device(torch.zeros(4, 3), 21)
    with pytest.raises(ValueError):
        morton.morton_encode_device(torch.zeros(4, 3, dtype=torch.int32), 22)


@pytest.mark.parametrize("n", [0, 1, 1_000, 70_003])
def test_morton_sort_device_matches_jax_and_host(n):
    cells = _cells(max(n, 2), 21, seed=n)[:n]
    codes, order = sort.morton_sort_device(cells, device="cpu")
    h_codes, h_order = sort.morton_sort_host(cells)
    assert codes.dtype == np.uint64 and order.dtype == np.int64
    np.testing.assert_array_equal(codes, h_codes)
    np.testing.assert_array_equal(order, h_order)
    np.testing.assert_array_equal(h_codes, jax_sort.morton_sort_host(cells)[0])
    if n:
        j_codes, j_order = jax_sort.morton_sort_device(cells)
        np.testing.assert_array_equal(codes, j_codes)
        np.testing.assert_array_equal(order, j_order)


def test_sort_by_codes_device_is_stable_and_carries_values():
    codes = torch.tensor([5, 3, 5, 0, 3, 2**63 - 1, 0], dtype=torch.int64)
    vals = torch.arange(7)
    pos = torch.arange(21, dtype=torch.float32).reshape(7, 3)
    got_codes, got_vals, got_pos = morton.sort_by_codes_device(codes, vals,
                                                               pos)
    assert got_codes.tolist() == [0, 0, 3, 3, 5, 5, 2**63 - 1]
    assert got_vals.tolist() == [3, 6, 1, 4, 0, 2, 5]
    torch.testing.assert_close(got_pos, pos[got_vals], rtol=0, atol=0)


# --- the full device core ---------------------------------------------------


@pytest.mark.parametrize("depth,max_split_level,n",
                         [(21, 21, 160_000), (12, 8, 120_000)])
def test_build_tree_device_matches_jax(depth, max_split_level, n):
    cells = _cells(n, depth, seed=depth)
    j = jax_build_tree_device(jnp.asarray(cells), depth, max_split_level,
                              max_points_per_node=2_000)
    t = build_tree_device(morton.cells_to_tensor(cells, "cpu"), depth,
                          max_split_level, max_points_per_node=2_000)
    np.testing.assert_array_equal(
        _u64(t.codes),
        jax_morton.join_u64(np.asarray(j.code_hi), np.asarray(j.code_lo)))
    np.testing.assert_array_equal(t.order.numpy(), np.asarray(j.order))
    np.testing.assert_array_equal(t.final_level.numpy(),
                                  np.asarray(j.final_level))
    np.testing.assert_array_equal(t.leaf_level.numpy(),
                                  np.asarray(j.leaf_level))
    assert len(np.unique(t.final_level.numpy())) >= 3

    # t_norm: the exact formula, bit for bit.
    c = cells[t.order.numpy()].astype(np.int64)
    s = (depth - t.final_level.numpy().astype(np.int64))[:, None]
    exact = ((c & ((1 << s) - 1)).astype(np.float32) + np.float32(0.5)) / (
        (1 << s).astype(np.float32))
    assert t.t_norm.dtype == torch.float32
    np.testing.assert_array_equal(t.t_norm.numpy().view(np.uint32),
                                  exact.view(np.uint32))
    # The JAX value: bit for bit while every node spans at most 2^12 cells
    # a side (XLA:CPU's exp2 is exact there); past that within its error.
    j_t = np.asarray(j.t_norm)
    if depth <= 12:
        np.testing.assert_array_equal(t.t_norm.numpy().view(np.uint32),
                                      j_t.view(np.uint32))
    else:
        assert not np.array_equal(exact, j_t)  # the JAX exp2 fault shows
        np.testing.assert_allclose(t.t_norm.numpy(), j_t, rtol=2**-20,
                                   atol=0)

    # The same order and levels as the core on the codes.
    order, final, leaf = build_tree_device_codes(
        t.codes[torch.argsort(t.order)], depth, max_split_level, 2_000)
    np.testing.assert_array_equal(order.numpy(), t.order.numpy())
    np.testing.assert_array_equal(final.numpy(), t.final_level.numpy())
    np.testing.assert_array_equal(leaf.numpy(), t.leaf_level.numpy())


# --- the mesh and the exchange ----------------------------------------------


def test_make_mesh_shard_and_replicate():
    mesh = make_mesh(3, device="cpu")
    assert mesh == tuple(torch.device("cpu", i) for i in range(3))
    assert make_mesh(device="cpu") == (torch.device("cpu", 0),)
    # Given devices are taken as they are, repeats included, then cut to n.
    cpu = torch.device("cpu")
    assert make_mesh(devices=[cpu, cpu, "cpu"]) == (cpu, cpu, cpu)
    assert make_mesh(2, devices=["cpu", "cpu", "cpu"]) == (cpu, cpu)
    with pytest.raises(ValueError):
        make_mesh(devices=[])
    x = np.arange(12).reshape(6, 2)
    parts = shard(x, mesh)
    assert [p.tolist() for p in parts] == [x[:2].tolist(), x[2:4].tolist(),
                                           x[4:].tolist()]
    with pytest.raises(ValueError, match="divide"):
        shard(np.arange(7), mesh)
    assert all(torch.equal(r, torch.arange(4))
               for r in replicate(np.arange(4), mesh))
    shared = replicate(np.arange(4), (cpu, cpu))
    assert shared[0] is shared[1]


def test_make_mesh_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kwargs in ({}, {"n_devices": 2}, {"device": "cuda:0"},
                   {"devices": ["cuda:0", "cuda:0"]}):
        with pytest.raises(RuntimeError, match="is_available"):
            make_mesh(**kwargs)


@pytest.mark.parametrize("n_shards", [2, 3, 5])
def test_all_to_all_places_blocks_as_jax_tiled(n_shards):
    cap = 4
    x = np.arange(n_shards * n_shards * cap * 2, dtype=np.int32).reshape(
        n_shards * n_shards, cap, 2)
    jmesh = cpu_mesh(n_shards)

    def step(a):
        return jax.lax.all_to_all(a, "shard", 0, 0, tiled=True)

    want = np.asarray(jax.jit(jax.shard_map(
        step, mesh=jmesh, in_specs=P("shard"), out_specs=P("shard")))(
        jax.device_put(x, NamedSharding(jmesh, P("shard")))))
    mesh = make_mesh(n_shards, device="cpu")
    send = [s.reshape(n_shards, cap, 2) for s in shard(x, mesh)]
    got = TS.all_to_all(send, mesh)
    assert [g.shape for g in got] == [(n_shards * cap, 2)] * n_shards
    np.testing.assert_array_equal(torch.cat(got).numpy(),
                                  want.reshape(-1, 2))
    with pytest.raises(ValueError):
        TS.all_to_all(send[:-1], mesh)


def test_every_kernel_launch_runs_under_the_device_guard(monkeypatch):
    """Each launcher calls its C entry (and reads the stream) inside
    `_ext.device_guard` of its tensors, so a shard on cuda:k launches on
    card k.  Rehearsed on CPU tensors with the library, the guard and the
    CUDA test stubbed."""
    from point_cloud_viewer_tpu_torch.ops import (
        cull_cuda,
        hbm_probe,
        leaf_levels_cuda,
        level_cuda,
        scan_cuda,
    )

    state = {"depth": 0, "guarded": []}

    class Guard:
        def __init__(self, t):
            self.t = t

        def __enter__(self):
            state["depth"] += 1

        def __exit__(self, *exc):
            state["depth"] -= 1

    class FakeLib:
        def __getattr__(self, name):
            def entry(*args):
                if name.startswith("pcv_") and name.endswith(
                        ("tile_rows", "max_axes")):
                    return {"pcv_cull_max_axes": 64}.get(name, 256)
                assert state["depth"] == 1, f"{name} called unguarded"
                state["guarded"].append(name)
                return 0
            return entry

    def stream_ptr(t):
        assert state["depth"] == 1, "stream read unguarded"
        return 0

    monkeypatch.setattr(_ext, "device_guard", Guard)
    monkeypatch.setattr(_ext, "lib", lambda: FakeLib())
    monkeypatch.setattr(_ext, "on_cuda", lambda name, *t: True)
    monkeypatch.setattr(_ext, "stream_ptr", stream_ptr)
    wrappers = (scan_cuda.scan_1d, level_cuda.seg_start_pass,
                level_cuda.leaf_update_pass, level_cuda.promote_pass,
                level_cuda.promote_stage, leaf_levels_cuda.leaf_stage,
                leaf_levels_cuda.leaf_levels, cull_cuda.cull_lod,
                hbm_probe.stream_probe)
    counts = [w.launches for w in wrappers]
    try:
        n = 64
        i32 = torch.zeros(n, dtype=torch.int32)
        u8 = torch.zeros(n, dtype=torch.uint8)
        codes = torch.arange(n, dtype=torch.int64)
        scan_cuda.scan_1d(i32, "sum")
        level_cuda.seg_start_pass(u8, 3)
        level_cuda.leaf_update_pass(u8, i32, u8.clone(), u8.clone(), 3, 5)
        level_cuda.promote_pass(u8, u8.clone(), 3)
        level_cuda.promote_stage(u8, u8.clone(), 21, 0)
        leaf_levels_cuda.leaf_stage(codes, 21, 21, 5)
        leaf_levels_cuda.leaf_levels(codes, 21, 21, 5)
        f32 = torch.zeros(n, dtype=torch.float32)
        hbm_probe.stream_probe("copy", f32, torch.zeros(1))
        cull_cuda.cull_lod(torch.eye(4), torch.zeros(3, 3), torch.zeros(3),
                           torch.ones(3), torch.zeros(n, 3), torch.ones(n),
                           torch.ones(n, dtype=torch.int32))
    finally:
        for w, c in zip(wrappers, counts):
            w.launches = c
    assert state["depth"] == 0
    assert set(state["guarded"]) == {
        "pcv_scan_i32", "pcv_seg_start", "pcv_leaf_update", "pcv_promote",
        "pcv_leaf_stage", "pcv_stream_probe", "pcv_cull"}


# --- the exact distributed sort ---------------------------------------------


@pytest.mark.parametrize("n_shards", MESHES)
def test_sharded_morton_sort_matches_jax(n_shards):
    mesh, jmesh = make_mesh(n_shards, device="cpu"), cpu_mesh(n_shards)
    # One point (pads on every other shard), then a ragged 8195 points.
    for n in (1, 8 * 1024 + 3):
        cells = _cells(max(n, 2), 21, seed=n)[:n]
        codes, order = TS.sharded_morton_sort(cells, mesh, 21)
        h_codes = jax_morton.morton_encode(cells)
        h_order = np.argsort(h_codes, kind="stable")
        np.testing.assert_array_equal(order, h_order)
        np.testing.assert_array_equal(codes, h_codes[h_order])
    j_codes, j_order = JS.sharded_morton_sort(cells, jmesh, 21)
    np.testing.assert_array_equal(codes, j_codes)
    np.testing.assert_array_equal(order, j_order)
    # The skewed cloud at capacity factor 1.0: the same retries.
    cells = _skewed_cells()
    stats, j_stats = {}, {}
    got = TS.sharded_morton_sort(cells, mesh, 21, capacity_factor=1.0,
                                 stats=stats)
    want = JS.sharded_morton_sort(cells, jmesh, 21, capacity_factor=1.0,
                                  stats=j_stats)
    assert stats == j_stats
    assert stats["attempts"] >= (2 if n_shards > 1 else 1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sharded_morton_sort_raises_after_retries():
    with pytest.raises(RuntimeError, match="overflow"):
        TS.sharded_morton_sort(_skewed_cells(), make_mesh(8, device="cpu"),
                               21, capacity_factor=0.5, max_retries=2)


# --- the distributed derivation ---------------------------------------------


@pytest.mark.parametrize("n_shards,b_levels,cap", [
    (1, 3, 18), (2, 2, 21), (3, 3, 18), (5, 2, 21), (8, 3, 18)])
def test_sharded_tree_levels_match_jax(n_shards, b_levels, cap):
    """Shard by shard, at B = 2 (the builder's choice up to 8 shards) and
    B = 3 with a resolution cap below the code depth."""
    codes = jax_morton.morton_encode(_skewed_cells())
    got = TS.sharded_tree_levels(codes, make_mesh(n_shards, device="cpu"),
                                 21, b_levels, cap, 700)
    want = JS.sharded_tree_levels(codes, cpu_mesh(n_shards), 21, b_levels,
                                  cap, 700)
    assert len(got) == len(want) == n_shards
    for (o, f, lv), (jo, jf, jlv) in zip(got, want):
        assert o.dtype == np.int64 and f.dtype == lv.dtype == np.uint8
        np.testing.assert_array_equal(o, jo)
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(lv, jlv)
    order = np.concatenate([o for o, _, _ in got])
    np.testing.assert_array_equal(order, np.argsort(codes, kind="stable"))


# --- the f32 stats step -----------------------------------------------------


def _canonical(codes, pos):
    """Positions ordered within each run of equal codes."""
    o = np.lexsort((pos[:, 2], pos[:, 1], pos[:, 0], codes))
    return pos[o].view(np.uint32)


@pytest.mark.parametrize("n_shards", MESHES)
def test_sharded_build_step_matches_jax(n_shards):
    """At capacity factor 1.0, so every mesh past one shard drops points."""
    jmesh = cpu_mesh(n_shards)
    n = n_shards * 256
    small = np.random.default_rng(7).random((n, 3), dtype=np.float32) * 100
    small[::5] = small[0]  # equal codes
    j_step = JS.make_sharded_build_step(jmesh, stats_level=3,
                                        capacity_factor=1.0)
    jr, j_total = j_step(
        jax.device_put(small, NamedSharding(jmesh, P("shard"))),
        jax.device_put(jnp.zeros(3, jnp.float32), NamedSharding(jmesh, P())),
        jax.device_put(jnp.float32(100.0), NamedSharding(jmesh, P())))
    step = TS.make_sharded_build_step(make_mesh(n_shards, device="cpu"),
                                      stats_level=3, capacity_factor=1.0)
    r, total = step(small, np.zeros(3, np.float32), np.float32(100.0))
    valid = np.asarray(jr.valid_count)
    assert r.valid_count == valid.tolist()
    assert r.overflow == np.asarray(jr.overflow).tolist()
    assert total == int(np.asarray(j_total)[0])
    assert sum(r.valid_count) + sum(r.overflow) == n
    assert (sum(r.overflow) > 0) == (n_shards > 1)
    hi = np.asarray(jr.code_hi).reshape(n_shards, -1)
    lo = np.asarray(jr.code_lo).reshape(n_shards, -1)
    pos = np.asarray(jr.positions).reshape(n_shards, -1, 3)
    for s in range(n_shards):
        want = jax_morton.join_u64(hi[s, :valid[s]], lo[s, :valid[s]])
        np.testing.assert_array_equal(_u64(r.codes[s]), want)
        np.testing.assert_array_equal(
            _canonical(want, r.positions[s].numpy()),
            _canonical(want, pos[s, :valid[s]]))


def test_node_stats_rejects_a_deep_level():
    with pytest.raises(ValueError, match="too deep"):
        TS._node_stats(torch.zeros(4, dtype=torch.int64), 21, 11)


# --- empty inputs -------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 5, 8])
def test_sharded_entrypoints_accept_empty_input(n_shards):
    mesh = make_mesh(n_shards, device="cpu")
    codes, order = TS.sharded_morton_sort(np.empty((0, 3), np.uint32), mesh,
                                          21)
    assert codes.dtype == np.uint64 and len(codes) == len(order) == 0
    shards = TS.sharded_tree_levels(np.empty(0, np.uint64), mesh, depth=21,
                                    b_levels=1, max_split_level=21,
                                    max_points_per_node=100_000)
    assert len(shards) == n_shards
    assert all(len(i) == len(f) == len(lv) == 0 for i, f, lv in shards)
    step = TS.make_sharded_build_step(mesh)
    r, total = step(np.empty((0, 3), np.float32), np.zeros(3, np.float32),
                    np.float32(1.0))
    assert total == 0 and sum(r.valid_count) == 0 and sum(r.overflow) == 0
    # Fewer points than shards: most shards hold pads only, and (with the
    # points in one level-B cell) most own nothing after the exchange.
    few = np.full((3, 3), 5, np.uint32)
    codes = jax_morton.morton_encode(few)
    got = TS.sharded_tree_levels(codes, mesh, 21, 2, 21, 100_000)
    want = JS.sharded_tree_levels(codes, cpu_mesh(n_shards), 21, 2, 21,
                                  100_000)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(TS.sharded_morton_sort(few, mesh, 21)[1],
                                  np.arange(3))
